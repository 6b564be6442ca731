"""SceneRepresentation: the mutable edit state and the edit's render.

Counterpart of ``autovfx_tpu/edit/scene_representation.py``: the same
directory layout, ``inserted_objects`` / ``fire_objects`` /
``smoke_objects`` / ``events`` lists, ``total_frames`` / ``fps``, the
same file caches, and ``render_scene`` = rigid bodies -> background,
object, smoke and shadow passes -> composite, with the edit config JSON
(``edit_ir.EditConfig``, ``rb_transform`` included) written beside the
frames.

Every pass renders through ``ops.rasterize.rasterize`` (kernels 1-3 on a
CUDA device, their plain versions on the CPU) frame by frame, and stays
a tensor on the scene's device (``SceneParams.device``) up to the
composite; a finished frame goes to the host once, for its PNG.  The
scene ORs every render's duplicate-budget overflow into ``overflowed``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core import ply_io
from autovfx_tpu_torch.core.gaussians import Gaussians, merge
from autovfx_tpu_torch.core.quaternion import (
    euler_to_rotmat,
    quat_to_rotmat,
    rotmat_to_quat,
)
from autovfx_tpu_torch.edit import mesh_io
from autovfx_tpu_torch.edit.edit_ir import EditConfig
from autovfx_tpu_torch.ops.rasterize import RasterConfig, RenderOutput
from autovfx_tpu_torch.ops.rasterize import rasterize as _rasterize
from autovfx_tpu_torch.physics import solver as PS
from autovfx_tpu_torch.physics.world import (
    RigidWorld,
    rb_transform_schema,
    simulate,
)
from autovfx_tpu_torch.render import composite as RCOMP
from autovfx_tpu_torch.render import envmap as REnv
from autovfx_tpu_torch.render import ibl as RIBL
from autovfx_tpu_torch.render import meshsplat as RMS
from autovfx_tpu_torch.render import shadow as RSH
from autovfx_tpu_torch.utils import png

# approach speed (m/s) above which a contact counts as a fracture-
# triggering impact; resting contacts approach at ~0, a half-metre drop
# arrives at ~3 m/s
FRACTURE_IMPACT_SPEED = 0.7
NO_DEPTH = 1e9  # a pass's depth where it covers under 1 %


@dataclass
class SceneParams:
    """The flags the pipeline consumes, and the device it runs on
    (``"cuda"`` unless the caller asks for the CPU)."""

    source_path: str = ""
    model_path: str = ""
    gaussians_ckpt_path: str = ""
    scene_mesh_path: str = ""
    custom_traj_name: Optional[str] = None
    anchor_frame_idx: int = 0
    scene_scale: float = 1.0
    downscale_factor: float = 1.0
    render_type: str = "MULTI_VIEW"
    num_frames: int = 1
    max_sh_degree: int = 4
    is_uv_mesh: bool = False
    is_indoor_scene: bool = False
    waymo_scene: bool = False
    deva_dino_threshold: float = 0.45
    edit_text: str = ""
    blender_output_dir_name: str = "blender_output"
    env_map_path: Optional[str] = None  # precomputed DiffusionLight HDR
    # alternative to env_map_path: directory of SDXL chrome-ball crops
    # named ball_ev<EV*10>.png/npy (e.g. ball_ev0.npy, ball_ev-25.npy);
    # the unwrap + HDR merge then run here (render/difflight.py)
    ball_crops_dir: Optional[str] = None
    dup_budget: int = 1 << 21
    light_samples: int = 64
    # indoor emitter mesh sampled into area lights
    emitter_mesh_path: Optional[str] = None
    white_background: bool = False
    cache_dir: Optional[str] = None
    device: str = devices.DEFAULT


def _pass_depth(out: RenderOutput) -> torch.Tensor:
    depth = out.depth / torch.clamp(out.alpha, min=1e-6)
    return torch.where(out.alpha > 0.01, depth,
                       torch.full_like(depth, NO_DEPTH))


def _host_image(color: torch.Tensor) -> np.ndarray:
    """A [0, 1] float image as uint8 on the host (truncated, as the
    reference writes its PNGs)."""
    return (np.clip(color.detach().cpu().numpy(), 0, 1) * 255).astype(
        np.uint8)


class SceneRepresentation:
    """Mutable scene + edit state, on ``hparams.device``."""

    def __init__(self, hparams: SceneParams):
        self.hparams = hparams
        self.device = devices.resolve(hparams.device)
        self.scene_scale = hparams.scene_scale
        self.fps = 15
        self.cache_dir = hparams.cache_dir or os.path.join(
            hparams.model_path or ".", "cache"
        )
        self.traj_results_dir = os.path.join(self.cache_dir, "traj")
        self.tracking_results_dir = os.path.join(self.cache_dir, "tracking")
        self.blender_output_dir = os.path.join(
            self.cache_dir, hparams.blender_output_dir_name
        )
        for d in (
            self.cache_dir,
            self.traj_results_dir,
            self.tracking_results_dir,
            self.blender_output_dir,
        ):
            os.makedirs(d, exist_ok=True)

        # edit state
        self.inserted_objects: List[Dict] = []
        self.fire_objects: List[str] = []
        self.smoke_objects: List[str] = []
        self.events: List[Dict] = []

        self.scene_mesh_path_for_blender = hparams.scene_mesh_path
        self.gaussians: Optional[Gaussians] = None
        self.cameras: Optional[C.Camera] = None
        self.c2w: Optional[np.ndarray] = None
        self.overflowed = torch.zeros((), dtype=torch.bool,
                                      device=self.device)
        self._mesh_cache: Dict[str, mesh_io.Mesh] = {}
        self._surfel_cache: Dict[str, dict] = {}
        self._env = None
        self._env_sh = None
        self._env_ggx = None
        self._lights = None
        self._mirror_tris = None
        self._emitter_cache = None
        self._melt_sims: Dict[str, tuple] = {}
        self._melt_idx: Dict[str, torch.Tensor] = {}
        self._smoke_traj = None
        self._fragments: Dict[str, list] = {}
        self._world_segments = None
        self.rb_transform: Optional[Dict] = None

        if hparams.gaussians_ckpt_path:
            self.load_scene()
        if hparams.custom_traj_name or hparams.source_path:
            self.load_cameras()

    # ---- loading -----------------------------------------------------------

    def load_scene(self):
        self.gaussians = ply_io.load_gaussians(
            self.hparams.gaussians_ckpt_path, device=self.device
        )

    def load_cameras(self):
        if self.hparams.custom_traj_name:
            path = os.path.join(
                self.hparams.source_path,
                "custom_camera_path",
                self.hparams.custom_traj_name + ".json",
            )
            self.cameras, self.c2w, _ = C.load_custom_trajectory(
                path, self.hparams.downscale_factor, device=self.device
            )

    @property
    def total_frames(self) -> int:
        if self.hparams.render_type == "MULTI_VIEW" and self.cameras is not None:
            return C.num_cameras(self.cameras)
        return self.hparams.num_frames

    @property
    def camera_position(self) -> np.ndarray:
        return self.anchor_camera.center.cpu().numpy()

    @property
    def camera_rotation(self) -> np.ndarray:
        """(3, 3) anchor-frame camera-to-world rotation (columns = the
        OpenCV x/y/z camera axes in the world)."""
        return self.anchor_camera.R.T.cpu().numpy()  # w2c transposed

    @property
    def anchor_camera(self) -> C.Camera:
        return C.index_camera(self.cameras, self.hparams.anchor_frame_idx)

    def insert_object(self, object_info: Dict):
        assert isinstance(object_info, dict)
        self.inserted_objects.append(object_info)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ---- environment lighting ----------------------------------------------

    def render_global_env_map(self):
        """Load (or default) the HDR envmap, cached per anchor frame.

        DiffusionLight inference is an external model; its output (a
        camera-frame equirect HDR) is read from ``hparams.env_map_path``
        and rotated into the world frame here.
        """
        if self._env is not None:
            return
        cache = os.path.join(
            self.cache_dir, f"env_{self.hparams.anchor_frame_idx:05d}.npy"
        )
        if os.path.exists(cache):
            env_world = np.load(cache)
        elif getattr(self.hparams, "ball_crops_dir", None):
            # DiffusionLight's post-processing: only the SDXL ball inpaint
            # is precomputed; unwrap, EV merge and rotation run here
            from autovfx_tpu_torch.render import difflight as DLGT

            crops = DLGT.load_ball_crops(self.hparams.ball_crops_dir)
            env_world = DLGT.envmap_from_ball_crops(
                crops, c2w=self.anchor_camera.c2w.cpu().numpy(),
                device=self.device,
            )
            np.save(cache, env_world)
        elif self.hparams.env_map_path:
            env_cam = REnv.load_envmap(self.hparams.env_map_path)
            env_world = REnv.rotate_envmap_cam_to_world(
                self._tensor(env_cam), self.anchor_camera.c2w
            ).cpu().numpy()
            np.save(cache, env_world)
        else:
            # neutral studio sky: mild gradient, brighter up
            h, w = 64, 128
            v = np.linspace(0, 1, h)[:, None, None]
            env_world = (1.2 - 0.8 * v) * np.ones((h, w, 3), np.float32)
        self._env = self._tensor(env_world.astype(np.float32))
        self._env_sh = self._tensor(RIBL.envmap_sh9(env_world))
        self._env_ggx = self._tensor(
            RIBL.prefilter_envmap_ggx(env_world, device=self.device))

    def get_sunlight_direction(self) -> np.ndarray:
        self.render_global_env_map()
        return REnv.sun_direction(self._env).cpu().numpy()

    def _shadow_lights(self):
        """The shadow pass's (directions (L, 3), weights (L,)) on the
        device: ``light_samples`` catcher-cosine envmap draws about +z,
        stratified and deduplicated (cached)."""
        if self._lights is None:
            dirs, contrib = REnv.importance_directions(
                self._env.cpu().numpy(), self.hparams.light_samples,
                up=np.array([0.0, 0.0, 1.0]), stratified=True, dedup=True,
            )
            self._lights = (self._tensor(dirs),
                            self._tensor(contrib.sum(-1)))
        return self._lights

    # ---- meshes --------------------------------------------------------------

    def _load_mesh(self, path: str) -> mesh_io.Mesh:
        if path not in self._mesh_cache:
            self._mesh_cache[path] = mesh_io.load_mesh(path)
        return self._mesh_cache[path]

    def _mirror_scene_tris(self, max_faces: int = 30_000):
        """The scene mesh (decimated) as ray-cast targets for mirror
        bounces: (tri_a, tri_b, tri_c, per-face albedo) on the device,
        cached; the albedo is the vertex colors' mean (0.5 grey
        without)."""
        if self._mirror_tris is not None:
            return self._mirror_tris
        path = self.scene_mesh_path_for_blender
        if not path or not os.path.exists(path):
            return None
        mesh = self._load_mesh(path)
        v, f = np.asarray(mesh.vertices), np.asarray(mesh.faces)
        vc = mesh.vertex_colors
        if len(f) > max_faces:
            from autovfx_tpu_torch.sugar.decimate import decimate_quadric

            v2, f2 = decimate_quadric(
                np.asarray(v, np.float64), f, max_faces // 2
            )
            if vc is not None and len(v2):
                # nearest-original-vertex color transfer (chunked host
                # NN on a subsample: mirror-bounce albedo is low-freq)
                vc = np.asarray(vc, np.float32)
                src_v = np.asarray(v, np.float32)
                if len(src_v) > 100_000:
                    sel = np.linspace(
                        0, len(src_v) - 1, 100_000
                    ).astype(np.int64)
                    src_v, vc = src_v[sel], vc[sel]
                sq_s = (src_v * src_v).sum(-1)
                out = np.empty((len(v2), 3), np.float32)
                v2f = np.asarray(v2, np.float32)
                for s in range(0, len(v2f), 1024):
                    q = v2f[s : s + 1024]
                    d2 = (
                        (q * q).sum(-1)[:, None]
                        - 2.0 * q @ src_v.T
                        + sq_s[None, :]
                    )
                    out[s : s + 1024] = vc[np.argmin(d2, axis=1)]
                vc = out
            v, f = v2, f2
        if vc is None:
            fcol = np.full((len(f), 3), 0.5, np.float32)
        else:
            fcol = np.asarray(vc, np.float32)[f].mean(1)
        va = np.asarray(v, np.float32)
        self._mirror_tris = tuple(
            self._tensor(x) for x in (va[f[:, 0]], va[f[:, 1]], va[f[:, 2]],
                                      fcol))
        return self._mirror_tris

    def _emitter_lights(self):
        """Cached area-light samples of the indoor emitter mesh
        (``emitter_mesh_path``) or None."""
        path = getattr(self.hparams, "emitter_mesh_path", None)
        if not path or not os.path.exists(path):
            return None
        if self._emitter_cache is None:
            from autovfx_tpu_torch.render.emitter import load_emitter

            self._emitter_cache = load_emitter(path, device=self.device)
        return self._emitter_cache

    def _object_surfels(self, obj: Dict, num_samples: int = 60_000) -> dict:
        """The object's surfels (``meshsplat.sample_mesh_surfels``'s
        tensors on the device), cached per asset and material."""
        path = obj["object_path"]
        mat = obj.get("material") or {}
        mat_path = mat.get("material_path")
        key = path if not mat_path else f"{path}|{mat_path}|{mat.get('rgb')}"
        if key not in self._surfel_cache:
            anim = None
            if path.lower().endswith(".glb"):
                # an animated asset plays its own clip: surfels are
                # sampled on the clip's rest mesh so that their (tri,
                # bary) associations match the deformed vertices
                from autovfx_tpu_torch.edit import gltf_anim as GA

                anim = GA.load_animated_glb(path)
            if anim is not None:
                mesh = anim.rest_mesh()
            else:
                mesh = self._load_mesh(path)
            if not obj.get("from_3DGS", False):
                lo, hi = mesh.bounds
                norm_scale = 1.0 / max(float((hi - lo).max()), 1e-9)
                norm_center = (lo + hi) / 2
                mesh = mesh.normalized_to_unit_box()
            else:
                norm_scale, norm_center = 1.0, np.zeros(3)
            surf = RMS.sample_mesh_surfels(
                mesh.vertices,
                mesh.faces,
                num_samples=num_samples,
                vertex_colors=mesh.vertex_colors,
                uv=mesh.uv,
                texture=mesh.texture,
                device=self.device,
            )
            if mat_path:
                surf = self._with_material(surf, mat)
            if anim is not None:
                surf["anim"] = anim
                surf["anim_norm"] = (
                    float(norm_scale),
                    np.asarray(norm_center, np.float32),
                )
            self._surfel_cache[key] = surf
        return self._surfel_cache[key]

    def _with_material(self, surf: dict, mat: dict) -> dict:
        """PolyHaven maps baked onto the surfels (on the host); an rgb
        beside a texture is a hue-shift recolor, not a multiply, so
        ``render_object_pass`` then skips its base-color multiply."""
        from autovfx_tpu_torch.render import materials as RMAT

        try:
            material = RMAT.load_material_folder(mat["material_path"])
        except FileNotFoundError:
            return surf
        host = {k: v.cpu().numpy() for k, v in surf.items()}
        host = RMAT.apply_material_to_surfels(host, material)
        if mat.get("rgb") is not None:
            host["colors"] = RMAT.hue_shift_colors(host["colors"], mat["rgb"])
        out = {k: torch.as_tensor(np.asarray(v), device=self.device)
               for k, v in host.items()}
        out["material_baked"] = True
        return out

    def _animate_surfels(self, surf: dict, frame_idx: int) -> dict:
        """Replay the asset's own clip at this frame (cyclic repeat)."""
        anim = surf.get("anim")
        if anim is None:
            return surf
        from autovfx_tpu_torch.edit import gltf_anim as GA

        t = frame_idx / float(self.fps)
        verts = anim.vertices_at(t)
        s, c = surf["anim_norm"]
        verts = (verts - c[None]) * s
        moved = GA.surfels_on_deformed(
            {k: surf[k].cpu().numpy() for k in ("tri", "bary")}, verts,
            anim.faces)
        out = dict(surf)
        out["points"] = self._tensor(moved["points"])
        out["normals"] = self._tensor(moved["normals"])
        return out

    def _object_vertices_for_physics(self, obj: Dict) -> np.ndarray:
        """The object's mesh vertices in its own frame (the rotation is
        the body's orientation at the start)."""
        mesh = self._load_mesh(obj["object_path"])
        if not obj.get("from_3DGS", False):
            mesh = mesh.normalized_to_unit_box()
        return mesh.vertices

    # ---- physics -------------------------------------------------------------

    def run_physics(self) -> Dict:
        """Simulate the rigid bodies of all inserted objects on the
        device; returns and stores the ``rb_transform`` dict."""
        if not self.inserted_objects:
            self.rb_transform = {}
            return self.rb_transform

        objects = []
        verts = []
        for obj in self.inserted_objects:
            o = dict(obj)
            o["_rot_matrix"] = np.asarray(o.get("rot", np.eye(3)), np.float32)
            objects.append(o)
            verts.append(self._object_vertices_for_physics(obj))

        sv = sf = None
        if self.scene_mesh_path_for_blender and os.path.exists(
            self.scene_mesh_path_for_blender
        ):
            scene_mesh = self._load_mesh(self.scene_mesh_path_for_blender)
            sv, sf = scene_mesh.vertices, scene_mesh.faces

        cfg = PS.SolverConfig(fps=float(self.fps))
        world = RigidWorld.from_objects(
            objects, verts, scene_vertices=sv, scene_faces=sf, cfg=cfg,
            device=self.device,
        )
        # orientations from the full rotation matrices
        quats = np.stack([
            rotmat_to_quat(torch.tensor(o["_rot_matrix"])).numpy()
            for o in objects])
        world.state = world.state.replace(quat=self._tensor(quats))
        # per-frame physics windows from the events + kinematic
        # trajectory animations
        from autovfx_tpu_torch.edit.events import physics_enabled_schedule
        from autovfx_tpu_torch.physics.animation import kinematic_schedule

        sched = physics_enabled_schedule(
            self.inserted_objects, self.events, self.total_frames
        )
        kin = kinematic_schedule(self.inserted_objects, self.total_frames)

        # break events segment the simulation at the earliest break frame
        break_frames = {}
        for ev in self.events:
            if ev["event_type"] == "break":
                break_frames[ev["object_id"]] = int(
                    ev.get("start_frame") or self.total_frames // 2
                ) - 1
        for o in self.inserted_objects:
            if o.get("break") and o["object_id"] not in break_frames:
                break_frames[o["object_id"]] = self.total_frames // 2

        # collision-triggered fracture (allow_fracture): a probe run, and
        # the object shatters at its first real impact through the same
        # segmentation as 'break'
        fracture_ids = [
            o["object_id"]
            for o in self.inserted_objects
            if o.get("fracture") and o["object_id"] not in break_frames
        ]
        if fracture_ids:
            _, _, _, impacts = simulate(
                world, self.total_frames, enabled_schedule=sched,
                kinematic=kin, return_impacts=True,
            )
            for oid in fracture_ids:
                bi = [o["object_id"] for o in objects].index(oid)
                hits = np.nonzero(impacts[:, bi] > FRACTURE_IMPACT_SPEED)[0]
                if len(hits):
                    break_frames[oid] = int(hits[0]) + 1

        self._fragments = {}
        if not break_frames:
            _, pos, quat = simulate(
                world, self.total_frames, enabled_schedule=sched,
                kinematic=kin,
            )
            self.rb_transform = rb_transform_schema(world, pos, quat)
            self._world_segments = [(world, (pos, quat), 0)]
            return self.rb_transform

        f_break = max(min(break_frames.values()), 1)
        final1, pos1, quat1 = simulate(
            world, f_break, enabled_schedule=sched[:f_break], kinematic=kin
        )
        rb1 = rb_transform_schema(world, pos1, quat1)

        # shatter the breaking objects; build the segment-2 world
        from autovfx_tpu_torch.physics.fracture import (
            burst_velocities,
            fracture_mesh,
        )

        host = lambda x: x.cpu().numpy()
        st_pos, st_quat = host(final1.pos), host(final1.quat)
        st_lin, st_ang = host(final1.linvel), host(final1.angvel)
        objects2, verts2, linvels2 = [], [], []
        keep_map = []  # segment-2 body index -> (kind, ref)
        for i, o in enumerate(objects):
            oid = o["object_id"]
            if oid not in break_frames:
                objects2.append(o)
                verts2.append(verts[i])
                linvels2.append(st_lin[i])
                keep_map.append(("body", i))
                continue
            mesh = self._load_mesh(o["object_path"])
            if not o.get("from_3DGS", False):
                mesh = mesh.normalized_to_unit_box()
            pieces = fracture_mesh(mesh.vertices, mesh.faces, num_pieces=8)
            rot_i = host(quat_to_rotmat(final1.quat[i]))
            com_i = st_pos[i]
            scale_i = float(o.get("scale", 1.0))
            vels = burst_velocities(pieces, st_lin[i], st_ang[i], np.zeros(3))
            origin_i = com_i - rot_i @ (world.com_offsets[i])
            rb_parent = o.get("rigid_body") or {}
            for pi, (pv, pf) in enumerate(zip(pieces.vertices, pieces.faces)):
                frag_id = f"{oid}_frag{pi}"
                frag_obj = {
                    "object_id": frag_id,
                    "object_name": frag_id,
                    "pos": origin_i,
                    "rot": rot_i,
                    "scale": scale_i,
                    "rigid_body": {
                        "rb_type": "ACTIVE",
                        "mass": float(
                            rb_parent.get("mass", 1.0)
                            * pieces.mass_fractions[pi]
                        ),
                        "restitution": float(
                            rb_parent.get("restitution", 0.5)
                        ),
                    },
                }
                objects2.append(frag_obj)
                verts2.append(pv)
                linvels2.append(vels[pi])
                keep_map.append(("frag", (oid, pi)))
                self._fragments.setdefault(oid, []).append(
                    {
                        "object": frag_obj,
                        "vertices": pv,
                        "faces": pf,
                        "visible_from": f_break,
                        "material": o.get("material"),
                    }
                )

        world2 = RigidWorld.from_objects(
            objects2, verts2, scene_vertices=sv, scene_faces=sf, cfg=cfg,
            device=self.device,
        )
        # carry over segment-1's end state for the surviving bodies
        pos2 = host(world2.state.pos).copy()
        quat2 = host(world2.state.quat).copy()
        lin2 = np.zeros_like(pos2)
        ang2 = np.zeros_like(pos2)
        for j, (kind, ref) in enumerate(keep_map):
            lin2[j] = linvels2[j]
            if kind == "body":
                pos2[j] = st_pos[ref]
                quat2[j] = st_quat[ref]
                ang2[j] = st_ang[ref]
        world2.state = world2.state.replace(
            pos=self._tensor(pos2),
            quat=self._tensor(quat2),
            linvel=self._tensor(lin2),
            angvel=self._tensor(ang2),
        )
        n2 = self.total_frames - f_break
        sched2 = np.ones((n2, len(objects2)), bool)
        for j, (kind, ref) in enumerate(keep_map):
            if kind == "body":
                sched2[:, j] = sched[f_break:, ref]
        _, posb, quatb = simulate(world2, n2, enabled_schedule=sched2)
        rb2 = rb_transform_schema(world2, posb, quatb)

        # merge: surviving bodies get both segments; fragments appear
        # from f_break (earlier frames hold the parent's entry)
        rb = rb1
        for j, (kind, ref) in enumerate(keep_map):
            name = world2.names[j]
            seg2 = rb2[name]
            merged = rb.get(name, {})
            for t in range(n2):
                merged[str(f_break + t)] = seg2[str(t)]
            rb[name] = merged
        self.rb_transform = rb
        # per-frame hull poses for the shadows: frames before f_break use
        # the segment-1 world (the breaking parent on its pre-break
        # trajectory); fragments cast shadows from f_break on
        self._world_segments = [
            (world, (pos1, quat1), 0),
            (world2, (posb, quatb), f_break),
        ]
        return self.rb_transform

    # ---- rendering -----------------------------------------------------------

    def _raster_cfg(self) -> RasterConfig:
        return RasterConfig(dup_budget=self.hparams.dup_budget)

    def rasterize(self, g: Gaussians, cam: C.Camera,
                  bg: Optional[torch.Tensor] = None) -> RenderOutput:
        """``ops.rasterize.rasterize`` at the scene's duplicate budget;
        the overflow flag is ORed into ``overflowed`` (on the device, no
        read back)."""
        out = _rasterize(g, cam, bg=bg, config=self._raster_cfg())
        self.overflowed = self.overflowed | out.overflow
        return out

    def render_from_3DGS(
        self,
        frame_indices=None,
        post_rendering: bool = False,
        save_dir: Optional[str] = None,
    ):
        """Render the background (and, with ``post_rendering``, the
        merged 3DGS objects moved by ``rb_transform``) for each frame of
        ``frame_indices`` (any iterable of ints; all frames when None).

        Returns (colors (F, H, W, 3), depths (F, H, W), alphas (F, H, W))
        as tensors on the scene's device.  ``save_dir`` also gets each
        frame's PNG and depth ``.npy``.
        """
        frames = (range(self.total_frames) if frame_indices is None
                  else [int(i) for i in frame_indices])
        bg = torch.full((3,), 1.0 if self.hparams.white_background else 0.0,
                        device=self.device)
        needs_merge = bool(
            post_rendering
            and self.rb_transform
            and any(o.get("from_3DGS") for o in self.inserted_objects)
        )
        colors, depths, alphas = [], [], []
        for fi in frames:
            cam = C.index_camera(self.cameras, fi)
            g = self.gaussians
            if needs_merge:
                g = self._merge_object_gaussians(g, fi)
            out = self.rasterize(g, cam, bg=bg)
            colors.append(out.color)
            depths.append(out.depth)
            alphas.append(out.alpha)
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                png.write_png(os.path.join(save_dir, f"{fi:05d}.png"),
                              _host_image(out.color))
                np.save(os.path.join(save_dir, f"depth_{fi:05d}.npy"),
                        out.depth.cpu().numpy())
        return torch.stack(colors), torch.stack(depths), torch.stack(alphas)

    def _effect_progress(self, obj: Dict, frame_idx: int):
        """(melt_p, burn_p) for this object at this frame, from its flags
        and event windows."""
        from autovfx_tpu_torch.render import melt as RMELT

        oid = obj["object_id"]
        melt_p = burn_p = 0.0
        for ev in self.events:
            if ev["object_id"] != oid:
                continue
            prog = RMELT.effect_progress(
                frame_idx, int(ev.get("start_frame") or 1),
                ev.get("end_frame"), self.total_frames,
            )
            if ev["event_type"] == "melting":
                melt_p = max(melt_p, prog)
            elif ev["event_type"] == "incinerate":
                burn_p = max(burn_p, prog)
        if obj.get("melting") and melt_p == 0.0 and not any(
            ev["object_id"] == oid and ev["event_type"] == "melting"
            for ev in self.events
        ):
            melt_p = RMELT.effect_progress(
                frame_idx, 1, None, self.total_frames
            )
        return melt_p, burn_p

    def _fire_burn_progress(self, obj: Dict, frame_idx: int) -> float:
        """Burn-to-black factor: a burning object's base color goes to
        (0.1, 0.1, 0.1) linearly over the fire window."""
        from autovfx_tpu_torch.render import melt as RMELT

        oid = obj["object_id"]
        p = 0.0
        for ev in self.events:
            if ev["object_id"] == oid and ev["event_type"] == "fire":
                p = max(
                    p,
                    RMELT.effect_progress(
                        frame_idx, int(ev.get("start_frame") or 1),
                        ev.get("end_frame"), self.total_frames,
                    ),
                )
        if p == 0.0 and oid in self.fire_objects and not any(
            ev["object_id"] == oid and ev["event_type"] == "fire"
            for ev in self.events
        ):
            p = RMELT.effect_progress(frame_idx, 1, None, self.total_frames)
        return p

    def _static_transform(self, obj: Dict):
        """(scale, R (3, 3) numpy, t (3,) numpy) of the object's rest
        pose (rb_transform frame 0 if simulated, else its placement).
        Melting objects are solved in world space from this pose."""
        tr = (
            self.rb_transform.get(obj["object_id"], {}).get("0")
            if self.rb_transform
            else None
        )
        if tr is not None:
            rot = euler_to_rotmat(*[float(x) for x in tr["rot"]]).numpy()
            return float(tr["scale"][0]), rot, np.asarray(tr["pos"], np.float32)
        return (
            float(obj.get("scale", 1.0)),
            np.asarray(obj.get("rot", np.eye(3)), np.float32),
            np.asarray(obj.get("pos", np.zeros(3)), np.float32),
        )

    def _melt_liquid(self, obj: Dict, points: np.ndarray,
                     normals: Optional[np.ndarray]):
        """The whole clip's thin-film liquid solve for a melting object
        (cached per object), on the device.  ``points`` / ``normals``
        are world-space samples (posed surfels or splat centers); the
        scene mesh, when there is one, is the solver's bed."""
        from autovfx_tpu_torch.render import liquid as LQ

        oid = obj["object_id"]
        if oid in self._melt_sims:
            return self._melt_sims[oid]
        prog = np.array(
            [
                self._effect_progress(obj, f)[0]
                for f in range(self.total_frames)
            ],
            np.float32,
        )
        cfg = LQ.LiquidConfig()
        sim = LQ.MeltSim(points, normals, cfg=cfg, device=self.device)
        path = self.scene_mesh_path_for_blender
        if path and os.path.exists(path):
            mesh = self._load_mesh(path)
            bed = LQ.bed_from_mesh(
                np.asarray(mesh.vertices), np.asarray(mesh.faces),
                np.asarray(sim.origin), sim.extent, cfg.resolution,
                ground_z=sim.ground_z, device=self.device,
            )
            sim = LQ.MeltSim(
                points, normals, ground_z=sim.ground_z, bed=bed, cfg=cfg,
                device=self.device,
            )
        frames = sim.run(prog)
        self._melt_sims[oid] = (sim, frames)
        return sim, frames

    def _merge_object_gaussians(self, g: Gaussians, frame_idx: int):
        """The scene with the 3DGS-extracted objects merged in, moved by
        their per-frame rigid pose; melting and incineration deform the
        splats directly."""
        from autovfx_tpu_torch.render import melt as RMELT

        merged = g
        for obj in self.inserted_objects:
            if not obj.get("from_3DGS"):
                continue
            gp = obj.get("gaussians_path")
            if not gp or not os.path.exists(gp):
                continue
            og = ply_io.load_gaussians(gp, device=self.device)
            melt_p, burn_p = self._effect_progress(obj, frame_idx)
            # melting objects stay at their rest pose: the liquid solve
            # owns all motion after the melt's onset
            tr = self.rb_transform.get(obj["object_id"], {}).get(
                "0" if melt_p > 0.0 else str(frame_idx)
            )
            if tr is not None:
                rot = euler_to_rotmat(*[float(x) for x in tr["rot"]])
                og = og.transformed(
                    scale=float(tr["scale"][0]),
                    rotation_quat=rotmat_to_quat(rot).to(self.device),
                    translation=self._tensor(tr["pos"]),
                    pivot=torch.zeros(3, device=self.device),
                )
            if melt_p > 0.0:
                from autovfx_tpu_torch.render import liquid as LQ

                oid = obj["object_id"]
                idx = self._melt_idx.get(oid)
                if idx is None:
                    # solved once from the rest-pose splat centers
                    idx = torch.nonzero(og.active)[:, 0]
                    self._melt_idx[oid] = idx
                    sim, mf = self._melt_liquid(
                        obj, og.xyz[idx].cpu().numpy(), None)
                else:
                    sim, mf = self._melt_sims[oid]
                f = min(frame_idx, mf.tracer_pos.shape[0] - 1)
                og = LQ.apply_melt_to_gaussians(og, idx, mf, f, sim.cell)
            if burn_p > 0.0:
                og = RMELT.incinerate_gaussians(og, burn_p)
            merged = merge(merged, og)
        return merged

    def _fragment_surfels(self, oid: str, pi: int, frag: Dict) -> dict:
        key = f"__frag__{oid}_{pi}"
        if key not in self._surfel_cache:
            self._surfel_cache[key] = RMS.sample_mesh_surfels(
                frag["vertices"], frag["faces"], num_samples=6_000,
                device=self.device,
            )
        return self._surfel_cache[key]

    def _draw_list(self, frame_idx: int):
        """Objects (and debris fragments) visible at this frame."""
        frags = self._fragments or {}
        out = []
        for obj in self.inserted_objects:
            if obj.get("from_3DGS"):
                continue
            oid = obj["object_id"]
            if oid in frags and frame_idx >= frags[oid][0]["visible_from"]:
                continue  # parent replaced by debris
            out.append((obj, self._object_surfels(obj)))
        for oid, pieces in frags.items():
            for pi, frag in enumerate(pieces):
                if frame_idx >= frag["visible_from"]:
                    out.append(
                        (frag["object"], self._fragment_surfels(oid, pi, frag))
                    )
        return out

    def _object_transform(self, obj: Dict, frame_idx: int):
        """(scale, R (3, 3), t (3,)) on the device: the simulated pose at
        this frame, else the placement."""
        tr = (self.rb_transform.get(obj["object_id"], {}).get(str(frame_idx))
              if self.rb_transform else None)
        if tr is not None:
            rot = euler_to_rotmat(*[float(x) for x in tr["rot"]])
            return (float(tr["scale"][0]), rot.to(self.device),
                    self._tensor(tr["pos"]))
        return (float(obj.get("scale", 1.0)),
                self._tensor(obj.get("rot", np.eye(3))),
                self._tensor(obj.get("pos", np.zeros(3))))

    def render_object_pass(self, frame_idx: int):
        """Inserted (non-3DGS) objects as IBL-shaded surfels: (color
        (H, W, 3), alpha (H, W), depth (H, W), 1e9 where uncovered) on
        the device."""
        from autovfx_tpu_torch.render import melt as RMELT

        self.render_global_env_map()
        cam = C.index_camera(self.cameras, frame_idx)
        gs = []
        for obj, surf in self._draw_list(frame_idx):
            surf = self._animate_surfels(surf, frame_idx)
            melt_p, burn_p = self._effect_progress(obj, frame_idx)
            transform = None
            if melt_p > 0.0:
                # liquid melt: the surfels become tracers of the thin-film
                # solve (world space; the solve owns the pose)
                s0, R0, t0 = self._static_transform(obj)
                base_pts = surf["points"].cpu().numpy()
                w_pts = (s0 * base_pts) @ R0.T + t0
                w_nrm = surf["normals"].cpu().numpy() @ R0.T
                sim, mf = self._melt_liquid(obj, w_pts, w_nrm)
                f = min(frame_idx, mf.tracer_pos.shape[0] - 1)
                surf = dict(surf)
                surf["points"] = mf.tracer_pos[f]
                surf["normals"] = mf.tracer_norm[f]
                # spreading tracers thin out: grow the radii to keep cover
                surf["radius"] = surf["radius"] * float(s0) * (
                    1.0 + 0.6 * melt_p)
                transform = (1.0, torch.eye(3, device=self.device),
                             torch.zeros(3, device=self.device))
            if burn_p > 0.0:
                cols, op_scale = RMELT.incinerate_colors(surf["colors"],
                                                         burn_p)
                surf = dict(surf)
                surf["colors"] = cols
                if op_scale <= 0.0:
                    continue  # fully burned away
            fire_p = self._fire_burn_progress(obj, frame_idx)
            if fire_p > 0.0:
                surf = dict(surf)
                surf["colors"] = surf["colors"] * (1.0 - fire_p) + 0.1 * fire_p
            if transform is None:
                transform = self._object_transform(obj, frame_idx)
            mat = obj.get("material") or {}
            base = mat.get("rgb")
            # texture-baked surfels already took rgb as a hue shift
            if surf.get("material_baked"):
                base = None
            mirror_scene = (
                self._mirror_scene_tris() if mat.get("is_mirror") else None
            )
            gs.append(
                RMS.shaded_object_gaussians(
                    surf,
                    self._env,
                    self._env_sh,
                    cam.center,
                    base_color=None if base is None else self._tensor(base),
                    roughness=float(
                        mat.get("roughness", 0.5)
                        if not mat.get("is_mirror")
                        else 0.0
                    ),
                    metallic=float(
                        mat.get("metallic", 0.0)
                        if not mat.get("is_mirror")
                        else 1.0
                    ),
                    transform=transform,
                    env_ggx=self._env_ggx,
                    mirror_scene=mirror_scene,
                    emitter=self._emitter_lights(),
                )
            )
        if not gs:
            h, w = cam.height, cam.width
            return (
                torch.zeros((h, w, 3), device=self.device),
                torch.zeros((h, w), device=self.device),
                torch.full((h, w), NO_DEPTH, device=self.device),
            )
        g_all = gs[0]
        for extra in gs[1:]:
            g_all = merge(g_all, extra)
        out = self.rasterize(g_all, cam)
        return out.color, out.alpha, _pass_depth(out)

    def _smoke_trajectory(self):
        """Simulate the clip's smoke and fire (cached): (states, origin,
        extent, config, per-frame origin cells) or None.  The domain sits
        above each burning or smoking object; fire/smoke events gate the
        fuel inflow per frame."""
        if self._smoke_traj is not None:
            return self._smoke_traj
        ids = set(self.fire_objects) | set(self.smoke_objects)
        for ev in self.events:
            if ev["event_type"] in ("fire", "smoke"):
                ids.add(ev["object_id"])
        emitters = [
            o for o in self.inserted_objects if o["object_id"] in ids
        ]
        if not emitters:
            return None
        from autovfx_tpu_torch.edit.events import compile_event_schedule
        from autovfx_tpu_torch.render import smoke as SM

        centers = np.stack(
            [np.asarray(o["pos"], np.float32) for o in emitters]
        )
        extent = max(
            2.5 * float(np.ptp(centers, axis=0).max() + 1.0), 2.0
        )
        origin = centers.mean(0) - extent * np.array([0.5, 0.5, 0.15])
        cfg = SM.SmokeConfig(
            resolution=48,
            dt=1.0 / self.fps,
            with_fire=bool(self.fire_objects),
            dissolve_speed=30,
        )
        mask = torch.zeros((cfg.resolution,) * 3, device=self.device)
        for o in emitters:
            cell = (np.asarray(o["pos"]) - origin) / extent * cfg.resolution
            mask = torch.maximum(mask, SM.sphere_inflow(
                cfg, cell, 0.06 * cfg.resolution, device=self.device))
        # per-frame fuel from the events (default: always on)
        sched = compile_event_schedule(
            self.events,
            [o["object_id"] for o in emitters],
            self.total_frames,
        )
        fire_smoke = sched["fire"] | sched["smoke"]
        has_event = fire_smoke.any(axis=0)
        on = np.ones((self.total_frames,), bool)
        if has_event.any():
            on = fire_smoke[:, has_event].any(axis=1)
        # adaptive: the fixed-resolution domain recenters to follow the
        # plume
        traj, origins = SM.simulate_smoke(
            cfg, mask, self.total_frames, self._tensor(on, torch.bool),
            adaptive=True,
        )
        self._smoke_traj = (traj, origin.astype(np.float32), extent, cfg,
                            origins)
        return self._smoke_traj

    def render_smoke_pass(self, frame_idx: int):
        """Smoke (color, alpha, depth, premultiplied fire) of one frame on
        the device, rendered as splats, or None without smoke."""
        traj = self._smoke_trajectory()
        if traj is None:
            return None
        cam = C.index_camera(self.cameras, frame_idx)
        states, origin, extent, cfg, origin_cells = traj
        from autovfx_tpu_torch.render import smoke as SM

        cell = extent / cfg.resolution
        origin_f = self._tensor(origin) + origin_cells[frame_idx].to(
            torch.float32) * cell
        g_smoke = SM.smoke_to_gaussians(
            SM.apply_density_noise(
                states.density[frame_idx], frame_idx, cfg
            ),
            states.temperature[frame_idx],
            origin_f,
            extent,
            with_fire=cfg.with_fire,
        )
        out = self.rasterize(g_smoke, cam)
        # the render's color is already the premultiplied foreground
        # radiance (Σ T·α·c over black), which the compositor's fire
        # term adds as it is
        return out.color, out.alpha, _pass_depth(out), out.color

    def render_shadow_pass(self, frame_idx: int, bg_depth: torch.Tensor,
                           bg_alpha: torch.Tensor) -> torch.Tensor:
        """(H, W) envmap-visibility shadow ratio of the background
        pixels against the objects' hulls at this frame's pose."""
        self.render_global_env_map()
        segs = self._world_segments
        if not self.inserted_objects or self.rb_transform is None or not segs:
            return torch.ones_like(bg_depth)
        cam = C.index_camera(self.cameras, frame_idx)
        dirs, weights = self._shadow_lights()
        # hull planes at this frame's pose (a break edit switches worlds
        # at the break frame)
        world, (pos, quat), start = segs[0]
        for w_s, traj_s, s_s in segs[1:]:
            if frame_idx >= s_s:
                world, (pos, quat), start = w_s, traj_s, s_s
        local = min(frame_idx - start, len(pos) - 1)
        state_f = world.state.replace(pos=self._tensor(pos[local]),
                                      quat=self._tensor(quat[local]))
        planes, masks = RSH.object_hulls_world(world.shape, state_f)
        # melting objects: the physics hull stays full-size, but the
        # material has collapsed into the liquid, so the hull is refit to
        # this frame's tracers (solid remnant + puddle)
        for obj in self.inserted_objects:
            m_p, _ = self._effect_progress(obj, frame_idx)
            cached = self._melt_sims.get(obj["object_id"])
            if m_p <= 0.0 or cached is None:
                continue
            oid = obj["object_id"]
            if oid not in world.names:
                continue
            _, mf = cached
            f = min(frame_idx, mf.tracer_pos.shape[0] - 1)
            pts_t = mf.tracer_pos[f]
            lo = pts_t.amin(0) - 1e-3
            hi = pts_t.amax(0) + 1e-3
            eye = torch.eye(3, device=self.device)
            box = torch.cat([
                torch.stack([eye, -eye], dim=1).reshape(6, 3),
                torch.stack([hi, -lo], dim=1).reshape(6, 1)], dim=1)
            b = world.names.index(oid)
            planes, masks = planes.clone(), masks.clone()
            planes[b] = 0.0
            masks[b] = False
            planes[b, :6] = box
            masks[b, :6] = True
        planes, masks = RSH.trim_hull_planes(planes, masks)
        return RSH.shadow_ratio_map(
            cam, bg_depth, torch.clamp(bg_alpha, min=1e-3), dirs, weights,
            planes, masks,
        )

    def render_frame(self, frame_idx: int, bg_color: torch.Tensor,
                     bg_depth: torch.Tensor,
                     bg_alpha: torch.Tensor) -> torch.Tensor:
        """One edited frame from its background pass (``render_from_3DGS``'s
        color, depth and alpha): the object, shadow and smoke passes and
        the composite, (H, W, 3) on the device."""
        obj_c, obj_a, obj_d = self.render_object_pass(frame_idx)
        scene_d = bg_depth / torch.clamp(bg_alpha, min=1e-6)
        scene_d = torch.where(bg_alpha > 0.01, scene_d,
                              torch.full_like(scene_d, NO_DEPTH))
        ratio = self.render_shadow_pass(frame_idx, bg_depth, bg_alpha)
        smoke = self.render_smoke_pass(frame_idx)
        smoke_kw = {}
        if smoke is not None:
            s_c, s_a, s_d, fire_pre = smoke
            smoke_kw = dict(smoke_color=s_c, smoke_alpha=s_a,
                            smoke_depth=s_d, fire_premult=fire_pre)
        return RCOMP.composite_frame(RCOMP.CompositeInputs(
            bg_color=bg_color,
            scene_depth=scene_d,
            obj_color=obj_c,
            obj_alpha=obj_a,
            obj_depth=obj_d,
            shadow_ratio=ratio,
            catcher_alpha=torch.clamp(bg_alpha, 0, 1),
            **smoke_kw,
        ))

    def render_scene(self, skip_render_3DGS: bool = False, save: bool = True):
        """The full edit render: physics -> per-frame background, object,
        smoke and shadow passes -> composite.

        Returns the (F, H, W, 3) frames as a float32 tensor on the
        scene's device.  With ``save``, each frame's PNG goes to
        ``<blender_output_dir>/blended/`` (its one copy to the host) and
        the edit config JSON beside the cache."""
        self.run_physics()
        self.render_global_env_map()

        bg_c, bg_d, bg_a = self.render_from_3DGS(
            post_rendering=not skip_render_3DGS
        )
        out_dir = os.path.join(self.blender_output_dir, "blended")
        if save:
            os.makedirs(out_dir, exist_ok=True)
        frames = []
        for fi in range(self.total_frames):
            frame = self.render_frame(fi, bg_c[fi], bg_d[fi], bg_a[fi])
            frames.append(frame)
            if save:
                png.write_png(os.path.join(out_dir, f"{fi:04d}.png"),
                              _host_image(frame))
        if save:
            self.write_edit_config()
        return torch.stack(frames)

    # ---- edit IR --------------------------------------------------------------

    def write_edit_config(self, path: Optional[str] = None) -> str:
        cam0 = C.index_camera(self.cameras, 0)
        cfg = EditConfig(
            edit_text=self.hparams.edit_text,
            blender_cache_dir=self.blender_output_dir,
            im_width=self.cameras.width,
            im_height=self.cameras.height,
            K=cam0.K.cpu().numpy().tolist(),
            c2w=(
                self.c2w.tolist() if self.c2w is not None else []
            ),
            scene_mesh_path=self.scene_mesh_path_for_blender,
            is_uv_mesh=self.hparams.is_uv_mesh,
            output_dir_name=self.hparams.blender_output_dir_name,
            render_type=self.hparams.render_type,
            num_frames=self.total_frames,
            anchor_frame_idx=self.hparams.anchor_frame_idx,
            is_indoor_scene=self.hparams.is_indoor_scene,
            waymo_scene=self.hparams.waymo_scene,
            global_env_map_path=self.hparams.env_map_path or "",
            insert_object_info=self.inserted_objects,
            fire_objects=self.fire_objects,
            smoke_objects=self.smoke_objects,
            events=self.events,
            rb_transform=self.rb_transform,
            scene_scale=self.scene_scale,
            fps=self.fps,
        )
        path = path or os.path.join(self.cache_dir, "edit_config.json")
        cfg.to_json(path)
        return path
