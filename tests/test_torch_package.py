"""Package guards of the PyTorch port.

The machine with the card has no JAX, so the port must import, render
and take a training step with JAX and the JAX package unimportable;
importing it must not need ``nvcc``; and a CPU tensor must never reach
the CUDA library loader.
"""
import os
import subprocess
import sys
import textwrap

import pytest

import autovfx_tpu_torch
from autovfx_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RENDER_500 = textwrap.dedent("""
    import torch
    import autovfx_tpu_torch as P
    from autovfx_tpu_torch.core.cameras import look_at_camera
    from autovfx_tpu_torch.utils.synthetic import make_gaussians
    import numpy as np

    g = make_gaussians(500, np.random.default_rng(0), device="cpu")
    cam = look_at_camera([4.0, 0.6, 0.8], [0, 0, 0], [0, 0, 1],
                         fx=57.6, fy=57.6, width=64, height=48, device="cpu")
    out = P.rasterize(g, cam, config=P.RasterConfig(dup_budget=1 << 14))
    from autovfx_tpu_torch.core.cameras import stack_cameras
    cam_batch = stack_cameras([cam, cam])
    assert out.color.shape == (48, 64, 3)
    assert torch.isfinite(out.color).all() and float(out.alpha.max()) > 0.1
    from autovfx_tpu_torch.train import trainer as T
    cfg = T.TrainConfig(raster=P.RasterConfig(dup_budget=1 << 14))
    state, aux = T.train_step(T.init_state(g), cam, out.color.flip(1), cfg)
    assert state.step == 1 and torch.isfinite(aux.loss)
    assert not torch.equal(state.gaussians.xyz, g.xyz)
    # every module of the package imports without JAX
    import dataclasses, importlib, pkgutil
    for info in pkgutil.walk_packages(P.__path__, "autovfx_tpu_torch."):
        importlib.import_module(info.name)
    from autovfx_tpu_torch.physics import world as W
    from autovfx_tpu_torch.render import clip as CL
    from autovfx_tpu_torch.render import meshsplat as MS
    corners = np.array([[x, y, z] for x in (-.3, .3) for y in (-.3, .3)
                        for z in (-.3, .3)], np.float32)
    ground = np.array([[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]],
                      np.float32)
    world = W.RigidWorld.from_objects(
        [{"pos": [0, 0, 1.0]}], [corners], scene_vertices=ground,
        scene_faces=np.array([[0, 1, 2], [0, 2, 3]]), device="cpu")
    _, pos, quat = W.simulate(world, 2)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                      [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                      [1, 5, 7], [1, 7, 3]])
    traj = W.origin_trajectory(world, pos, quat)
    inp = CL.build_clip_inputs(
        g, cam_batch, [{}], [MS.sample_mesh_surfels(
            corners, faces, 300, device="cpu")], *traj, world.shape,
        np.ones((8, 16, 3), np.float32), num_lights=4, device="cpu")
    clip = CL.render_clip(inp, 2, P.RasterConfig(dup_budget=1 << 14),
                          fused=True)
    assert clip.shape == (2, 48, 64, 3) and torch.isfinite(clip).all()
    # the edit layer: a 2-frame drop edit from files, through render_scene
    import os, tempfile
    from autovfx_tpu_torch.core import cameras as C, ply_io
    from autovfx_tpu_torch.edit import edit_utils as EU, mesh_io
    from autovfx_tpu_torch.edit.edit_ir import default_object_info
    from autovfx_tpu_torch.edit.scene_representation import (
        SceneParams, SceneRepresentation)
    root = tempfile.mkdtemp()
    ply_io.save_ply(os.path.join(root, "scene.ply"), g)
    mesh_io.save_obj(os.path.join(root, "ground.obj"),
                     mesh_io.Mesh(ground, np.array([[0, 1, 2], [0, 2, 3]])))
    mesh_io.save_obj(os.path.join(root, "cube.obj"),
                     mesh_io.Mesh(corners, faces))
    C.save_custom_trajectory(
        os.path.join(root, "custom_camera_path", "ring.json"), cam_batch)
    scene = SceneRepresentation(SceneParams(
        source_path=root, gaussians_ckpt_path=os.path.join(root, "scene.ply"),
        scene_mesh_path=os.path.join(root, "ground.obj"),
        custom_traj_name="ring", dup_budget=1 << 17, light_samples=4,
        cache_dir=os.path.join(root, "cache"), device="cpu"))
    obj = default_object_info()
    obj.update(object_id="cube", object_name="cube",
               object_path=os.path.join(root, "cube.obj"),
               pos=np.array([0.0, 0.0, 1.0], np.float32), scale=0.4)
    EU.insert_object(scene, EU.allow_physics(obj))
    edit = scene.render_scene()
    assert edit.shape == (2, 48, 64, 3) and torch.isfinite(edit).all()
    assert os.path.exists(os.path.join(root, "cache", "edit_config.json"))
    assert not bool(scene.overflowed)
    # a removal edit: the object's extraction outputs made by hand, LaMa
    # from a tiny seeded checkpoint, 3 retraining steps, then
    # remove_object finds them, swaps the mesh and reloads the splats
    from autovfx_tpu_torch.perception import extract
    from autovfx_tpu_torch.train import inpaint_retrain
    from autovfx_tpu_torch.utils.synthetic import lama_state_dict
    base = os.path.join(scene.cache_dir, "extract", "cube", "1")
    for sub in ("object_mesh", "removal_mesh"):
        os.makedirs(os.path.join(base, sub))
    mesh_io.save_obj(os.path.join(base, "object_mesh", "object_mesh.obj"),
                     mesh_io.Mesh(corners, faces))
    mesh_io.save_obj(os.path.join(base, "removal_mesh", "removal_mesh.obj"),
                     mesh_io.Mesh(ground, np.array([[0, 1, 2], [0, 2, 3]])))
    ply_io.save_ply(os.path.join(base, "removal_gaussians.ply"),
                    dataclasses.replace(g, active=g.xyz[:, 2] > 0))
    ckpt = os.path.join(root, "lama.ckpt")
    torch.save({"state_dict": lama_state_dict(8, 2, 1)}, ckpt)
    os.environ["AUTOVFX_LAMA_CKPT"] = ckpt
    extract.inpaint_object(scene, "cube", 1)
    inpaint_retrain.training_3DGS_for_inpainting(
        scene, os.path.join(base, "removal_gaussians.ply"),
        os.path.join(base, "render_inpaint_lama"),
        os.path.join(base, "render_inpaint_mask"), base,
        os.path.join(base, "inpaint_camera_poses.json"), iterations=3,
        device="cpu")
    EU.remove_object(scene, {"object_name": "cube", "object_id": "c1",
        "object_path": os.path.join(base, "object_mesh", "object_mesh.obj")})
    assert scene.scene_mesh_path_for_blender.endswith(
        "inpaint_removal_mesh.obj")
    assert scene.gaussians.capacity == int((g.xyz[:, 2] > 0).sum())
    edit = scene.render_scene()
    assert edit.shape == (2, 48, 64, 3) and torch.isfinite(edit).all()
    new = {"perception.lama", "train.inpaint_retrain", "render.preview",
           "retrieval.objaverse_index", "retrieval.wrappers",
           "retrieval.build_index", "perception.gpt4v", "utils.video"}
    assert {"autovfx_tpu_torch." + m for m in new} <= set(sys.modules)
    blocked = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "autovfx_tpu")
               and sys.modules[m] is not None]
    assert not blocked, blocked
    print("OK")
""")


def run(code, env=None):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.fixture(scope="module")
def render_500():
    """``RENDER_500`` run once in a subprocess that can import neither JAX
    nor the JAX package and finds no ``nvcc`` and no CUDA toolkit: the
    one run checks both claims."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'autovfx_tpu'):\n"
        "    sys.modules[m] = None  # any import of them now raises\n"
        + RENDER_500
    )
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent", CUDA_PATH="/nonexistent")
    return run(code, env=env)


def test_imports_and_renders_without_jax(render_500):
    r = render_500
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


def test_import_needs_no_nvcc(render_500):
    r = render_500
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


def test_cpu_tensors_never_reach_the_loader(monkeypatch):
    from autovfx_tpu_torch.bench import kernel_launches
    from autovfx_tpu_torch.core.cameras import look_at_camera
    from autovfx_tpu_torch.train import trainer
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    def refuse(*_):
        raise AssertionError("the CUDA library was asked for on the CPU")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    counts = kernel_launches()
    g = make_garden_like(3000, seed=2, extent=2.67, device="cpu")
    cam = look_at_camera([2.6, 0.0, 1.4], [0, 0, 0.2], [0, 0, 1],
                         fx=48.0, fy=48.0, width=64, height=48, device="cpu")
    config = autovfx_tpu_torch.RasterConfig(dup_budget=1 << 15, tile=32)
    out = autovfx_tpu_torch.render(g, cam, config=config)
    assert out.rgba.shape == (48, 64, 4)
    state, aux = trainer.train_step(
        trainer.init_state(g), cam, out.rgba[..., :3].flip(0),
        trainer.TrainConfig(raster=config))
    assert state.adam.count == 1 and bool(aux.loss > 0)
    assert counts == kernel_launches()


def test_library_hash_follows_sources_and_flags(tmp_path, monkeypatch):
    """The build directory is keyed by the sources and the flags, so an
    edited kernel never loads a stale library."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path()
    (src / "a.cu").write_text("// two\n")
    assert _build.library_path() != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert len({first, _build.library_path()}) == 2


def test_kernel_sources_ship_with_the_package():
    names = {p.name for p in _build.sources()}
    assert {"preprocess.cu", "duplicate.cu", "blend_fwd.cu", "blend_bwd.cu",
            "preprocess_bwd.cu"} <= names
    for name in _build.SIGNATURES:
        text = "".join(p.read_text() for p in _build.sources())
        assert f'extern "C" int {name}(' in text, name


def test_prompts_ship_with_the_package():
    """The planner prompts sit in the package and are its package data."""
    import glob
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    pkg = os.path.dirname(autovfx_tpu_torch.__file__)
    found = {os.path.relpath(p, pkg) for pattern in data["autovfx_tpu_torch"]
             for p in glob.glob(os.path.join(pkg, pattern))}
    assert {"gpt/prompts/planner_prompt.txt",
            "gpt/prompts/planner_prompt_waymo.txt"} <= found


def _entry_points():
    """The loaders and constructors that put tensors on a device."""
    from autovfx_tpu_torch import convert
    from autovfx_tpu_torch.core import cameras, ply_io
    from autovfx_tpu_torch.dataset import (
        colmap, mono_normal, readers, trajectories,
    )
    from autovfx_tpu_torch.parallel import dryrun, launch
    from autovfx_tpu_torch.perception import lama
    from autovfx_tpu_torch.physics import shapes, world
    from autovfx_tpu_torch.render import clip, emitter, ibl, meshsplat, preview
    from autovfx_tpu_torch.sugar import extract_mesh, poisson, refine
    from autovfx_tpu_torch.train import (
        checkpoint, densify, init_points, inpaint_retrain,
    )
    from autovfx_tpu_torch.utils import synthetic, video

    return {
        "load_lama_params": lama.load_lama_params,
        "convert_torch_state_dict": lama.convert_torch_state_dict,
        "inpaint_with_params": lama.inpaint_with_params,
        "training_3DGS_for_inpainting":
            inpaint_retrain.training_3DGS_for_inpainting,
        "render_asset_previews": preview.render_asset_previews,
        "preview_views": preview.preview_views,
        "render_trajectory": video.render_trajectory,
        "RigidWorld.from_objects": world.RigidWorld.from_objects,
        "build_hulls": shapes.build_hulls,
        "build_mesh_grid": shapes.build_mesh_grid,
        "build_clip_inputs": clip.build_clip_inputs,
        "sample_mesh_surfels": meshsplat.sample_mesh_surfels,
        "prefilter_envmap_ggx": ibl.prefilter_envmap_ggx,
        "build_init_points": init_points.build_init_points,
        "ray_mesh_init_points": init_points.ray_mesh_init_points,
        "convert.clip_inputs": convert.clip_inputs,
        "load_ply": ply_io.load_ply,
        "load_gaussians": ply_io.load_gaussians,
        "load_sugar_pt": ply_io.load_sugar_pt,
        "load_npz": ply_io.load_npz,
        "load_custom_trajectory": cameras.load_custom_trajectory,
        "load_emitter": emitter.load_emitter,
        "load_checkpoint": checkpoint.load_checkpoint,
        "convert.gaussians": convert.gaussians,
        "convert.camera": convert.camera,
        "convert.train_state": convert.train_state,
        "camera_from_c2w": cameras.camera_from_c2w,
        "look_at_camera": cameras.look_at_camera,
        "make_gaussians": synthetic.make_gaussians,
        "make_garden_like": synthetic.make_garden_like,
        "make_scene": synthetic.make_scene,
        "garden_camera": synthetic.garden_camera,
        "DensifyStats.zero": densify.DensifyStats.zero,
        "colmap_to_cameras": colmap.colmap_to_cameras,
        "to_cameras": readers.to_cameras,
        "half_sphere_trajectory": trajectories.half_sphere_trajectory,
        "lemniscate_trajectory": trajectories.lemniscate_trajectory,
        "get_mono_normals": mono_normal.get_mono_normals,
        "convert.slabs": convert.slabs,
        "spawn": launch.spawn,
        "dryrun_multichip": dryrun.dryrun_multichip,
        "bind_to_mesh": refine.bind_to_mesh,
        "convert.bound_gaussians": convert.bound_gaussians,
        "poisson_reconstruct": poisson.poisson_reconstruct,
        "remove_outliers": extract_mesh.remove_outliers,
    }


def test_entry_points_default_to_the_card():
    import inspect

    for name, fn in _entry_points().items():
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", (name, default)


def _calls(tmp_path):
    """Each entry point's call with no device named, on inputs made on
    the CPU."""
    import dataclasses
    import operator

    import numpy as np
    import torch

    from autovfx_tpu_torch import convert
    from autovfx_tpu_torch.core import cameras, ply_io
    from autovfx_tpu_torch.edit import mesh_io
    from autovfx_tpu_torch.train import checkpoint, trainer
    from autovfx_tpu_torch.utils import synthetic

    fns = _entry_points()
    g = synthetic.make_gaussians(20, np.random.default_rng(0), device="cpu")
    cam = cameras.look_at_camera([3.0, 0.0, 1.0], [0, 0, 0], [0, 0, 1],
                                 fx=20.0, fy=20.0, width=24, height=16,
                                 device="cpu")
    ply = str(tmp_path / "g.ply")
    ply_io.save_ply(ply, g)
    pt = str(tmp_path / "sugar.pt")
    torch.save({"_points": g.xyz, "all_densities": g.opacity_logit[:, None],
                "_sh_coordinates_dc": g.sh_dc[:, None],
                "_sh_coordinates_rest": g.sh_rest, "_scales": g.log_scales,
                "_quaternions": g.quats}, pt)
    npz = str(tmp_path / "g.npz")
    ply_io.save_npz(npz, g)
    traj = str(tmp_path / "traj.json")
    cameras.save_custom_trajectory(traj, cameras.stack_cameras([cam, cam]))
    emitter_obj = str(tmp_path / "emitter.obj")
    mesh_io.save_obj(emitter_obj, mesh_io.Mesh(
        np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32),
        np.array([[0, 1, 2]])))
    ckpt = str(tmp_path / "state.npz")
    state = trainer.init_state(g)
    checkpoint.save_checkpoint(ckpt, state)
    g_arrays = {f: getattr(g, f).numpy() for f in convert.GAUSSIAN_FIELDS}
    cam_arrays = {f: (getattr(cam, f).numpy()
                      if f not in ("width", "height") else getattr(cam, f))
                  for f in convert.CAMERA_FIELDS}
    state_arrays = checkpoint.state_arrays(state)
    corners = np.array([[x, y, z] for x in (-.3, .3) for y in (-.3, .3)
                        for z in (-.3, .3)], np.float32)
    tri = np.array([[0, 1, 3], [0, 3, 2]])
    env = np.ones((4, 8, 3), np.float32)
    cam_batch = cameras.stack_cameras([cam, cam])
    surf = {"points": corners, "normals": corners, "colors": corners,
            "radius": np.float32(0.1)}
    hull = type("Hull", (), {"planes": np.zeros((1, 8, 4), np.float32),
                             "plane_mask": np.ones((1, 8), bool)})()
    from autovfx_tpu_torch.render import clip

    clip_args = (g, cam_batch, [{}], [surf], np.zeros((2, 1, 3)),
                 np.tile(np.eye(3), (2, 1, 1, 1)), hull, env)
    # every array of a clip's inputs, as another package would pass them
    clip_cpu = clip.build_clip_inputs(*clip_args, num_lights=2, device="cpu")
    clip_arrays = {f.name: getattr(clip_cpu, f.name).numpy()
                   for f in dataclasses.fields(clip_cpu)
                   if torch.is_tensor(getattr(clip_cpu, f.name))}
    images = np.zeros((2, 16, 24, 3), np.float32)
    from autovfx_tpu_torch.perception import lama
    from autovfx_tpu_torch.utils import png
    from autovfx_tpu_torch.utils.synthetic import lama_state_dict

    sd = lama_state_dict(8, 2, 1)
    lama_ckpt = str(tmp_path / "lama.ckpt")
    torch.save({"state_dict": sd}, lama_ckpt)
    lama_cpu = lama.convert_torch_state_dict(sd, device="cpu")
    views = tmp_path / "views"
    views.mkdir()
    for name in ("00000.png", "00001.png"):
        png.write_png(str(views / name), np.zeros((16, 24, 3), np.uint8))
    scene = type("Scene", (), {"scene_scale": 1.0, "hparams": type(
        "Hparams", (), {"dup_budget": 1 << 12})()})()
    cube = str(tmp_path / "cube.obj")
    mesh_io.save_obj(cube, mesh_io.Mesh(corners, tri))
    import chip_smoke
    from autovfx_tpu_torch.sugar import refine

    sparse = str(tmp_path / "sparse")
    chip_smoke.write_colmap_model(sparse, [cam, cam], corners,
                                  np.zeros((8, 3), np.uint8))
    bound = refine.bind_to_mesh(mesh_io.Mesh(corners, tri), device="cpu")
    bound_arrays = {f.name: (getattr(bound, f.name).numpy()
                             if f.name != "thickness_ratio"
                             else bound.thickness_ratio)
                    for f in dataclasses.fields(bound)}
    cloud = np.random.default_rng(0).standard_normal((40, 3)).astype(
        np.float32)
    from autovfx_tpu_torch.dataset import mono_normal, readers

    dataset_cams = readers.DatasetCameras(
        ["a.png"], np.eye(4)[None, :3], np.diag([20.0, 20.0, 1.0]),
        np.array([24, 16]))
    mono_normal.save_normal_map(
        mono_normal.normal_map_path(str(views), "00000.png"),
        np.ones((16, 24, 3)) / np.sqrt(3.0))
    return {
        "load_lama_params": lambda: fns["load_lama_params"](lama_ckpt).out_w,
        "convert_torch_state_dict": lambda: fns["convert_torch_state_dict"](
            sd).out_w,
        "inpaint_with_params": lambda: fns["inpaint_with_params"](
            lama_cpu, np.zeros((16, 24, 3), np.uint8),
            np.ones((16, 24), bool)),
        "training_3DGS_for_inpainting": lambda: fns[
            "training_3DGS_for_inpainting"](
            scene, ply, str(views), str(views), str(tmp_path), traj,
            iterations=1),
        "render_asset_previews": lambda: fns["render_asset_previews"](
            cube, str(tmp_path / "previews"), "cube", num_views=1, size=16),
        "preview_views": lambda: fns["preview_views"](cube, 1, 16),
        "render_trajectory": lambda: fns["render_trajectory"](
            g, cam_batch, str(tmp_path / "traj_out"),
            config=autovfx_tpu_torch.RasterConfig(dup_budget=1 << 12)),
        "RigidWorld.from_objects": lambda: fns["RigidWorld.from_objects"](
            [{"pos": [0, 0, 1]}], [corners]).state,
        "build_hulls": lambda: fns["build_hulls"]([corners])[0],
        "build_mesh_grid": lambda: fns["build_mesh_grid"](corners, tri)[:4],
        "build_clip_inputs": lambda: fns["build_clip_inputs"](
            *clip_args, num_lights=2).light_dirs,
        "sample_mesh_surfels": lambda: list(fns["sample_mesh_surfels"](
            corners, tri, 10).values()),
        "prefilter_envmap_ggx": lambda: fns["prefilter_envmap_ggx"](
            env, levels=2, out_hw=(2, 4), samples=2),
        "build_init_points": lambda: fns["build_init_points"](
            "ray_mesh", corners, corners, cam_batch, images, corners, tri),
        "ray_mesh_init_points": lambda: fns["ray_mesh_init_points"](
            cam_batch, images, corners, tri, 4),
        "convert.clip_inputs": lambda: fns["convert.clip_inputs"](
            clip_arrays, g, cam_batch).light_dirs,
        "load_ply": lambda: fns["load_ply"](ply),
        "load_gaussians": lambda: fns["load_gaussians"](ply),
        "load_sugar_pt": lambda: fns["load_sugar_pt"](pt),
        "load_npz": lambda: fns["load_npz"](npz),
        "load_custom_trajectory": lambda: fns["load_custom_trajectory"](
            traj)[0],
        "load_emitter": lambda: fns["load_emitter"](emitter_obj, 8),
        "load_checkpoint": lambda: fns["load_checkpoint"](ckpt),
        "convert.gaussians": lambda: fns["convert.gaussians"](g_arrays),
        "convert.camera": lambda: fns["convert.camera"](cam_arrays),
        "convert.train_state": lambda: fns["convert.train_state"](
            state_arrays),
        "camera_from_c2w": lambda: fns["camera_from_c2w"](
            np.eye(4), 20.0, 20.0, 12.0, 8.0, 24, 16),
        "look_at_camera": lambda: fns["look_at_camera"](
            [3.0, 0.0, 1.0], [0, 0, 0], [0, 0, 1], fx=20.0, fy=20.0,
            width=24, height=16),
        "make_gaussians": lambda: fns["make_gaussians"](
            20, np.random.default_rng(0)),
        "make_garden_like": lambda: fns["make_garden_like"](30),
        "make_scene": lambda: fns["make_scene"](20, 24, 16),
        "garden_camera": lambda: fns["garden_camera"](24, 16),
        "DensifyStats.zero": lambda: fns["DensifyStats.zero"](20),
        "colmap_to_cameras": lambda: fns["colmap_to_cameras"](sparse),
        "to_cameras": lambda: fns["to_cameras"](dataset_cams),
        "half_sphere_trajectory": lambda: fns["half_sphere_trajectory"](
            [0, 0, 0], 1.0, 0.5, 3, width=24, height_px=16),
        "lemniscate_trajectory": lambda: fns["lemniscate_trajectory"](
            [0, 0, 0], 1.0, 0.5, 3, width=24),
        "get_mono_normals": lambda: fns["get_mono_normals"](
            ["00000.png"], str(views)),
        "convert.slabs": lambda: fns["convert.slabs"](
            {k: v[None] for k, v in g_arrays.items()}, 0),
        "spawn": lambda: fns["spawn"](1, operator.add, backend="gloo"),
        "dryrun_multichip": lambda: fns["dryrun_multichip"](1),
        "bind_to_mesh": lambda: fns["bind_to_mesh"](
            mesh_io.Mesh(corners, tri)),
        "convert.bound_gaussians": lambda: fns["convert.bound_gaussians"](
            bound_arrays),
        "poisson_reconstruct": lambda: fns["poisson_reconstruct"](
            cloud, cloud, cloud.min(0), cloud.max(0), resolution=8),
        "remove_outliers": lambda: fns["remove_outliers"](cloud, cloud),
    }


# entry points that compute on the device and return numpy arrays or
# the paths of the files they wrote
HOST_RESULTS = ("prefilter_envmap_ggx", "build_init_points",
                "ray_mesh_init_points", "inpaint_with_params",
                "training_3DGS_for_inpainting", "render_asset_previews",
                "render_trajectory", "poisson_reconstruct",
                "remove_outliers", "spawn", "dryrun_multichip")


def _tensors(x):
    import dataclasses

    import torch

    if torch.is_tensor(x):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif not isinstance(x, (tuple, list)):
        return []
    return [t for v in x for t in _tensors(v)]


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_without_a_device(name, tmp_path):
    """With no device named, each entry point puts its tensors on the
    card, or, where there is none, raises an error that names the
    remedy; it never falls back to the CPU."""
    import torch

    call = _calls(tmp_path)[name]
    if torch.cuda.is_available():
        if name in HOST_RESULTS:  # numpy out, computed on the card
            call()
            return
        tensors = _tensors(call())
        assert tensors and all(t.is_cuda for t in tensors), name
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", os.path.dirname(sys.executable))
    monkeypatch.setattr(_build, "NVCC_FALLBACK", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_scene_and_cli_default_to_the_card(tmp_path):
    """``SceneParams`` and the CLI's ``--device`` default to the card;
    without one, the scene and ``run_scene_editing`` raise an error that
    names the remedy."""
    import torch

    from autovfx_tpu_torch import edit_scene
    from autovfx_tpu_torch.edit import scene_representation as SR

    opts = edit_scene.get_opts(["--gaussians_ckpt_path", "g.ply",
                                "--edit_text", "drop a cube",
                                "--model_path", str(tmp_path)])
    assert SR.SceneParams().device == "cuda" and opts.device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SR.SceneRepresentation(SR.SceneParams(cache_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        edit_scene.run_scene_editing(opts, opts.edit_text)


def test_reconstruction_cli_defaults_to_the_card(tmp_path):
    """``python -m autovfx_tpu_torch.train_gaussians``'s ``--device``
    defaults to the card; without one, the CLI raises an error that
    names the remedy before it reads the scene."""
    import torch

    from autovfx_tpu_torch import train_gaussians

    argv = ["--source_path", str(tmp_path / "scene"), "--model_path",
            str(tmp_path / "out")]
    assert train_gaussians.get_args(argv).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_gaussians.main(argv)


@pytest.mark.parametrize("module,argv", [
    ("train_at_scale", ["--splats", "200", "--iters", "1", "--width", "16",
                        "--height", "12", "--views", "2"]),
    ("utils.lpips_weights", ["--vgg16", "v.pth", "--lpips", "l.pth",
                             "--out", "w.npz"]),
    ("bench", []),
])
def test_tools_default_to_the_card(module, argv, tmp_path, monkeypatch):
    """``python -m autovfx_tpu_torch.train_at_scale``, ``...utils.
    lpips_weights`` and ``...bench``: ``--device`` defaults to the card;
    without one, the tool raises an error that names the remedy before
    it reads or writes anything."""
    import importlib

    import torch

    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    mod = importlib.import_module("autovfx_tpu_torch." + module)
    assert mod.get_args(argv).device == "cuda"
    if torch.cuda.is_available():
        return
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mod.main(argv)
    assert os.listdir(tmp_path) == []
