"""The edit DSL: the ~30 functions GPT-generated programs compose.

Counterpart of ``autovfx_tpu/edit/edit_utils.py``, with the same names,
signatures and draws from Python's ``random`` and numpy's global state,
in the same order, so a run seeded alike picks the same values.
``detect_object`` runs the port's extraction, ``remove_object`` the
removal renders, LaMa and the retraining, and ``retrieve_asset`` the
asset previews, all on the scene's device (kernels 1-4 and the
preprocess backward on the card); retrieval itself is the local index
and library of ``retrieval.wrappers``.
"""
from __future__ import annotations

import copy
import math
import os
import random

import numpy as np

from autovfx_tpu_torch.edit.edit_ir import (
    default_event_info,
    default_object_info,
)
from autovfx_tpu_torch.edit import mesh_io


class Material:
    """edit_utils.py:107-114."""

    def __init__(
        self,
        roughness=0.5,
        metallic=0.0,
        specular=0.5,
        material_path=None,
        is_mirror=False,
        rgb=None,
    ):
        self.roughness = roughness
        self.metallic = metallic
        self.specular = specular
        self.material_path = material_path
        self.is_mirror = is_mirror
        self.rgb = rgb


def _new_id() -> str:
    return "".join(
        random.choices("abcdefghijklmnopqrstuvwxyz0123456789", k=16)
    )


# ---- perception-backed ------------------------------------------------------------


def detect_object(scene_representation, object_name):
    """Detect + extract an instance mesh from the scene
    (edit_utils.py:117-146: DEVA track → largest instance → extraction).

    The tracker's masks are precomputed files (``perception.wrappers``);
    the extraction runs on the scene's device.
    """
    from autovfx_tpu_torch.perception.wrappers import run_deva
    from autovfx_tpu_torch.perception.extract import (
        extract_object_from_scene,
        get_largest_object,
    )

    print(f"Detecting object: {object_name}")
    tracking_dir = os.path.join(
        scene_representation.tracking_results_dir,
        "_".join(object_name.split(" ")),
    )
    if not os.path.exists(tracking_dir):
        run_deva(
            os.path.join(scene_representation.traj_results_dir, "images"),
            scene_representation.tracking_results_dir,
            object_name,
            scene_representation.hparams.deva_dino_threshold,
        )
    obj_ids = sorted(
        int(x) for x in os.listdir(tracking_dir) if x.isdigit()
    )
    if not obj_ids:
        raise ValueError(
            f"No instance of object {object_name} found in the tracking results."
        )
    obj_id = get_largest_object(scene_representation, object_name, obj_ids)
    obj_mesh_path = extract_object_from_scene(
        scene_representation, object_name, obj_id
    )
    new_obj = default_object_info()
    new_obj["object_name"] = object_name
    new_obj["object_id"] = _new_id()
    new_obj["object_path"] = obj_mesh_path
    new_obj["pos"] = mesh_io.load_mesh(obj_mesh_path).bottom_center()
    new_obj["from_3DGS"] = True
    new_obj["gaussians_path"] = os.path.join(
        os.path.dirname(os.path.dirname(obj_mesh_path)), "object_gaussians.ply"
    )
    return new_obj


def sample_point_on_object(scene_representation, obj):
    """Up-facing flat spot on the object (edit_utils.py:149-195):
    up-facing triangles within 10°, top surface by -z ray cast,
    neighbor-flatness filter, random pick."""
    mesh = mesh_io.load_mesh(obj["object_path"])
    normals = mesh.face_normals()
    cos_thr = np.cos(np.radians(10))
    up = np.abs(normals[:, 2]) > cos_thr
    centers = mesh.vertices[mesh.faces].mean(axis=1)
    cand = np.nonzero(up)[0]
    if len(cand) == 0:
        raise ValueError("No intersection point found on the object.")
    # top-surface: keep candidates whose center is the highest among
    # candidates within a small xy radius (ray-cast -z equivalent)
    c = centers[cand]
    # stable: equal heights keep their face order on every platform
    order = np.argsort(-c[:, 2], kind="stable")
    kept = []
    for i in order:
        xy = c[i, :2]
        higher = c[kept][:, :2] if kept else np.zeros((0, 2))
        if kept and (np.linalg.norm(higher - xy, axis=1) < 0.02).any():
            continue
        kept.append(i)
    # neighbor flatness: adjacency via shared edges
    edge_map = {}
    flat = set(cand.tolist())
    ok = []
    f = mesh.faces
    for t in range(len(f)):
        for e in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((f[t, e[0]], f[t, e[1]])))
            edge_map.setdefault(key, []).append(t)
    for i in kept:
        t = cand[i]
        neighbors = set()
        for e in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((f[t, e[0]], f[t, e[1]])))
            neighbors.update(edge_map.get(key, []))
        neighbors.discard(t)
        if all(n in flat for n in neighbors):
            ok.append(t)
    pool = centers[ok] if ok else c[kept]
    loc = pool[random.randint(0, len(pool) - 1)].astype(np.float32)
    print(
        "Sampling point on object: {} {} at location {}".format(
            obj["object_name"], obj["object_id"], loc
        )
    )
    return loc


def sample_point_above_object(scene_representation, obj, VERTICAL_OFFSET=0.6):
    """edit_utils.py:198-205 (+0.6 m / scene_scale above the surface)."""
    print(
        "Sampling point above object: {} {}".format(
            obj["object_name"], obj["object_id"]
        )
    )
    loc = sample_point_on_object(scene_representation, obj)
    loc = np.asarray(loc, np.float32).copy()
    loc[2] += VERTICAL_OFFSET / scene_representation.scene_scale
    return loc


def retrieve_asset(
    scene_representation, object_name, is_animated=False, is_generated=False
):
    """Retrieve a 3D asset (edit_utils.py:208-251): Objaverse/Meshy lookup,
    4-view preview render (on the scene's device), GPT-4V scale &
    forward-axis estimates; scale is divided by scene_scale (:249)."""
    from autovfx_tpu_torch.retrieval.wrappers import (
        retrieve_asset_from_meshy,
        retrieve_asset_from_objaverse,
    )
    from autovfx_tpu_torch.perception.gpt4v import (
        estimate_object_forward_axis,
        estimate_object_scale,
    )
    from autovfx_tpu_torch.render.preview import render_asset_previews

    if is_generated:
        assert not is_animated, "Generated object cannot be animated."
        obj_info = retrieve_asset_from_meshy(object_name)
    else:
        obj_info = retrieve_asset_from_objaverse(
            object_name, is_animated=is_animated
        )
    new_obj = default_object_info()
    new_obj["object_name"] = object_name
    new_obj["object_id"] = obj_info["object_id"]
    new_obj["object_path"] = obj_info["object_path"]
    new_obj["from_3DGS"] = False

    preview_dir = os.path.join(
        scene_representation.cache_dir, "assets_rendering_multi_views"
    )
    img_folder = render_asset_previews(
        obj_info["object_path"], preview_dir, obj_info["object_id"],
        num_views=4, device=scene_representation.device,
    )

    forward_axis = "TRACK_NEGATIVE_Y"
    if is_animated:
        forward_axis = estimate_object_forward_axis(img_folder, object_name)
        print(f"Estimated forward axis of {object_name} is {forward_axis}.")
    axis_to_index = {
        "TRACK_NEGATIVE_Y": 0,
        "FORWARD_X": 1,
        "FORWARD_Y": 2,
        "TRACK_NEGATIVE_X": 3,
    }
    import glob as _glob

    imgs = sorted(_glob.glob(os.path.join(img_folder, "*.png")))
    img_path = imgs[axis_to_index[forward_axis]] if imgs else None
    object_scale = estimate_object_scale(img_path, object_name)
    print(f"Estimated scale of {object_name} is {object_scale} meters.")

    new_obj["forward_axis"] = forward_axis
    new_obj["scale"] = object_scale / scene_representation.scene_scale
    return new_obj


# ---- state mutation (pure bookkeeping) --------------------------------------------


def insert_object(scene_representation, obj):
    """edit_utils.py:254-259."""
    scene_representation.insert_object(obj)
    print(
        "Inserting object: {} {}".format(obj["object_name"], obj["object_id"])
    )


def remove_object(scene_representation, obj, remove_gaussians=True):
    """edit_utils.py:262-290: swap the scene mesh for the inpainted one
    and (optionally) retrain the removal splats on the inpainted views,
    then reload the scene from ``inpaint_gaussians.ply``.  Each stage's
    output that exists is reused."""
    from autovfx_tpu_torch.perception.extract import inpaint_object

    obj_path = obj["object_path"]
    base_folder = os.path.dirname(os.path.dirname(obj_path))
    obj_name = os.path.basename(os.path.dirname(base_folder))
    obj_id = os.path.basename(base_folder)

    new_scene_mesh_path = os.path.join(
        base_folder, "inpaint_removal_mesh/inpaint_removal_mesh.obj"
    )
    if not os.path.exists(new_scene_mesh_path):
        inpaint_object(scene_representation, obj_name, obj_id)
    scene_representation.scene_mesh_path_for_blender = new_scene_mesh_path

    if remove_gaussians:
        new_gaussians_path = os.path.join(base_folder, "inpaint_gaussians.ply")
        if not os.path.exists(new_gaussians_path):
            from autovfx_tpu_torch.train.inpaint_retrain import (
                training_3DGS_for_inpainting,
            )

            training_3DGS_for_inpainting(
                scene_representation,
                os.path.join(base_folder, "removal_gaussians.ply"),
                os.path.join(base_folder, "render_inpaint_lama"),
                os.path.join(base_folder, "render_inpaint_mask"),
                base_folder,
                os.path.join(base_folder, "inpaint_camera_poses.json"),
                device=scene_representation.device,
            )
        scene_representation.hparams.gaussians_ckpt_path = new_gaussians_path
        scene_representation.load_scene()
    print(
        "Removing object: {} {}".format(obj["object_name"], obj["object_id"])
    )


def update_object(scene_representation, obj):
    """edit_utils.py:293-310 (fire/smoke-aware remove+insert)."""
    has_fire_smoke_event = any(
        ev["object_id"] == obj["object_id"]
        and ev["event_type"] in ("fire", "smoke")
        for ev in scene_representation.events
    )
    keep_gaussians = (
        obj["object_id"] in scene_representation.fire_objects
        or obj["object_id"] in scene_representation.smoke_objects
        or has_fire_smoke_event
    )
    remove_object(
        scene_representation, obj, remove_gaussians=not keep_gaussians
    )
    insert_object(scene_representation, obj)
    print(
        "Updating object: {} {}".format(obj["object_name"], obj["object_id"])
    )


def allow_physics(obj):
    """edit_utils.py:313-319."""
    obj["rigid_body"]["rb_type"] = "ACTIVE"
    print(
        "Allowing physics for object: {} {}".format(
            obj["object_name"], obj["object_id"]
        )
    )
    return obj


def add_fire(scene_representation, obj):
    """edit_utils.py:322-328."""
    scene_representation.fire_objects.append(obj["object_id"])
    print(
        "Adding fire to object: {} {}".format(
            obj["object_name"], obj["object_id"]
        )
    )
    return obj


def add_smoke(scene_representation, obj):
    """edit_utils.py:331-337."""
    scene_representation.smoke_objects.append(obj["object_id"])
    print(
        "Adding smoke to object: {} {}".format(
            obj["object_name"], obj["object_id"]
        )
    )
    return obj


def set_static_animation(obj):
    """edit_utils.py:340-351."""
    obj["animation"] = {"type": "static", "points": None}
    obj["rigid_body"]["rb_type"] = "KINEMATIC"
    print(
        "Allowing animation for object: {} {}".format(
            obj["object_name"], obj["object_id"]
        )
    )
    return obj


def set_moving_animation(obj, points):
    """edit_utils.py:354-363."""
    obj["animation"] = {"type": "trajectory", "points": points}
    obj["rigid_body"]["rb_type"] = "KINEMATIC"
    print(
        "Setting trajectory for object: {} {}".format(
            obj["object_name"], obj["object_id"]
        )
    )
    return obj


def retrieve_material(scene_representation, material_name):
    """edit_utils.py:366-372 (PolyHaven folder by SBERT name similarity)."""
    from autovfx_tpu_torch.retrieval.wrappers import (
        retrieve_materials_from_polyhaven,
    )

    return retrieve_materials_from_polyhaven(material_name)


def init_material():
    """edit_utils.py:375-379."""
    return Material()


def apply_material(obj, material):
    """edit_utils.py:382-395 (class -> dict)."""
    obj["material"] = {
        "roughness": material.roughness,
        "metallic": material.metallic,
        "specular": material.specular,
        "material_path": material.material_path,
        "is_mirror": material.is_mirror,
        "rgb": material.rgb,
    }
    print(
        "Applying material to object: {} {}".format(
            obj["object_name"], obj["object_id"]
        )
    )
    return obj


def allow_fracture(obj):
    """edit_utils.py:398-404."""
    obj["fracture"] = True
    print(
        "Fracturing object: {} {}".format(obj["object_name"], obj["object_id"])
    )
    return obj


# ---- geometry helpers ---------------------------------------------------------------


def get_object_bottom_position(obj):
    """edit_utils.py:407-412."""
    return obj["pos"]


def get_object_center_position(obj):
    """edit_utils.py:415-428."""
    mesh = mesh_io.load_mesh(obj["object_path"])
    if obj["from_3DGS"]:
        z_offset = mesh.center()[2] - mesh.bottom_center()[2]
        return obj["pos"] + np.array([0, 0, z_offset], np.float32)
    scale = mesh.extents()
    norm_scale = scale / max(scale.max(), 1e-9)
    z_offset = 0.5 * norm_scale[2] * obj["scale"]
    return obj["pos"] + np.array([0, 0, z_offset], np.float32)


def translate_object(obj, translation):
    """edit_utils.py:431-437."""
    obj["pos"] = np.asarray(obj["pos"], np.float32) + np.asarray(
        translation, np.float32
    )
    print(
        "Translating object: {} {}".format(
            obj["object_name"], obj["object_id"]
        )
    )
    return obj


def rotate_object(obj, rotation):
    """edit_utils.py:440-446."""
    obj["rot"] = np.asarray(rotation, np.float32) @ np.asarray(
        obj["rot"], np.float32
    )
    print(
        "Rotating object: {} {}".format(obj["object_name"], obj["object_id"])
    )
    return obj


def scale_object(obj, scale):
    """edit_utils.py:449-455."""
    obj["scale"] *= scale
    print(
        "Scaling object: {} {}".format(obj["object_name"], obj["object_id"])
    )
    return obj


def get_random_2D_rotation():
    """edit_utils.py:458-467."""
    angle = random.uniform(0, 2 * math.pi)
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def get_random_3D_rotation():
    """edit_utils.py:470-475."""
    from scipy.spatial.transform import Rotation as R

    return R.random().as_matrix().astype(np.float32)


def make_copy(obj):
    """edit_utils.py:478-484 (deep copy, fresh 16-char id)."""
    new_obj = copy.deepcopy(obj)
    new_obj["object_id"] = _new_id()
    return new_obj


# ---- time-varying events --------------------------------------------------------------


def make_break(obj):
    """edit_utils.py:487-493."""
    obj["break"] = True
    print(
        "Breaking object: {} {}".format(obj["object_name"], obj["object_id"])
    )
    return obj


def make_melting(obj):
    """edit_utils.py:496-502."""
    obj["melting"] = True
    print(
        "Melting object: {} {}".format(obj["object_name"], obj["object_id"])
    )
    return obj


def get_camera_position(scene_representation):
    """edit_utils.py:514-518."""
    return scene_representation.camera_position


def add_event(
    scene_representation, obj, event_type, start_frame=None, end_frame=None
):
    """edit_utils.py:521-536 (break/incinerate default start at
    total_frames // 2)."""
    new_event = default_event_info()
    new_event["object_id"] = obj["object_id"]
    new_event["event_type"] = event_type
    if start_frame is not None:
        new_event["start_frame"] = start_frame
    else:
        new_event["start_frame"] = (
            scene_representation.total_frames // 2
            if event_type in ("break", "incinerate")
            else 1
        )
    new_event["end_frame"] = (
        end_frame
        if end_frame is not None
        else scene_representation.total_frames + 1
    )
    scene_representation.events.append(new_event)


# ---- driving-scene helpers (edit_utils.py:550-616) ------------------------------------


def get_vehicle_position(scene_representation):
    """edit_utils.py:550-556 (camera position with z = 0)."""
    position = scene_representation.camera_position.copy()
    position[2] = 0.0
    return position


def get_direction(scene_representation, direction="front"):
    """edit_utils.py:559-580: directions derived from the anchor
    camera's rotation (OpenCV axes: x right, y down, z forward) —
    front/back are the horizontal forward (up × x_axis), left/right
    follow the camera's x axis, up/down are world ±z."""
    if direction not in ("up", "down", "front", "back", "left", "right"):
        raise ValueError(f"Invalid direction: {direction}")
    R = scene_representation.camera_rotation
    x_axis = R[:, 0]
    mapping = {
        "up": np.array([0.0, 0.0, 1.0]),
        "down": np.array([0.0, 0.0, -1.0]),
        "front": np.cross(np.array([0.0, 0.0, 1.0]), x_axis),
        "back": np.cross(np.array([0.0, 0.0, -1.0]), x_axis),
        "left": -x_axis,
        "right": x_axis,
    }
    return np.asarray(mapping[direction], np.float32)


def retrieve_chatsim_asset(scene_representation, object_name):
    """edit_utils.py:583-616: look up the ChatSim vehicle bank."""
    from autovfx_tpu_torch.retrieval.wrappers import retrieve_chatsim_vehicle

    info = retrieve_chatsim_vehicle(object_name)
    new_obj = default_object_info()
    new_obj["object_name"] = object_name
    new_obj["object_id"] = info["object_id"]
    new_obj["object_path"] = info["object_path"]
    new_obj["from_3DGS"] = False
    new_obj["scale"] = 1.0 / scene_representation.scene_scale
    new_obj["forward_axis"] = info.get("forward_axis", "TRACK_NEGATIVE_Y")
    return new_obj
