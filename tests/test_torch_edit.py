"""The port's SceneRepresentation against the JAX package's, on the CPU.

The scene is ``tests/test_edit.py``'s (400 splats of JAX's
``make_gaussians(PRNGKey(0))`` above the ground mesh, the 4-camera 64×48
trajectory), written to files once and loaded by both packages; the
JAX side renders through ``backend="ref"``.  Its duplicate budget is
2^18, where neither package's object pass (60,000 surfels) overflows:
at ``test_edit.py``'s 2^14 both overflow, and past the budget the two
keep different duplicates (ROADMAP.md, queue 3).

The JAX object pass is shaded with unit view directions
(``unit_view_shading``): the reference's ``meshsplat.py:171`` scales
them by a matrix norm, a defect the port fixes and
``tests/test_torch_render.py`` pins.  The JAX passes run compiled, a
frame at a time (``jax_reference``).

Bounds: the scene and cameras within 1e-6; ``render_from_3DGS`` per
frame at PSNR > 90 dB (the plain-vs-ref budget of
``tests/test_torch_rasterize.py``); the edited frames on ≥ 99.5 % of
pixels within 1e-4 with a mean difference ≤ 1e-3 (the multi-pass budget
of ``tests/test_torch_clip_multipass.py``); ``rb_transform`` within
``tests/test_physics_golden.py``'s bounds (0.15 over the clip, 0.01 over
its last frames).
"""
import contextlib
import copy
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.core import ply_io as JPLY
from autovfx_tpu.edit import edit_utils as JEU
from autovfx_tpu.edit import mesh_io as JMIO
from autovfx_tpu.edit import scene_representation as JSR
from autovfx_tpu.edit.edit_ir import default_object_info
from autovfx_tpu.render import ibl as JIBL
from autovfx_tpu.render import meshsplat as JMS
from autovfx_tpu.utils.linalg import apply_rotation
from autovfx_tpu.utils.synthetic import make_gaussians
from autovfx_tpu_torch.edit import edit_utils as EU
from autovfx_tpu_torch.edit import scene_representation as SR

BUDGET = 1 << 18
PIXEL_TOL, PIXEL_SHARE, MEAN_TOL = 1e-4, 0.995, 1e-3
TRAJ_TOL, REST_TOL, REST_FRAMES = 0.15, 0.01, 5


def box_mesh(half=0.5, color=(0.8, 0.2, 0.2)):
    """``tests/test_edit.py``'s box."""
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                  for z in (-half, half)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int64)
    c = np.tile(np.asarray(color, np.float32), (len(v), 1))
    return JMIO.Mesh(vertices=v, faces=f, vertex_colors=c)


def ground_mesh(size=10.0):
    v = np.array([[-size, -size, 0], [size, -size, 0], [size, size, 0],
                  [-size, size, 0]], np.float32)
    return JMIO.Mesh(vertices=v, faces=np.array([[0, 1, 2], [0, 2, 3]],
                                                 np.int64))


def write_scene(root: str, n_cams: int = 4) -> dict:
    """``tests/test_edit.py``'s scene as files (made by the JAX package),
    its trajectory cut to the first ``n_cams`` of its 4 cameras: the
    keyword arguments both packages' ``SceneParams`` take."""
    g = make_gaussians(400, jax.random.PRNGKey(0), spread=1.5,
                       scale_range=(0.02, 0.08))
    g = g.replace(xyz=g.xyz.at[:, 2].multiply(0.1))
    ckpt = os.path.join(root, "scene.ply")
    JPLY.save_ply(ckpt, g)
    mesh_path = os.path.join(root, "scene_mesh.obj")
    JMIO.save_obj(mesh_path, ground_mesh())
    cams = JC.stack_cameras([
        JC.look_at_camera([3 * np.cos(a), 3 * np.sin(a), 1.6], [0, 0, 0],
                          [0, 0, 1], fx=50.0, fy=50.0, width=64, height=48)
        for a in np.linspace(0, np.pi / 2, 4)[:n_cams]])
    JC.save_custom_trajectory(
        os.path.join(root, "custom_camera_path", "test_traj.json"), cams)
    return dict(source_path=root, model_path=root, gaussians_ckpt_path=ckpt,
                scene_mesh_path=mesh_path, custom_traj_name="test_traj",
                dup_budget=BUDGET, light_samples=8)


def scenes(root: str, params: dict, **extra):
    """(JAX scene, port scene on the CPU), each with its own cache."""
    kw = dict(params, **extra)
    js = JSR.SceneRepresentation(JSR.SceneParams(
        cache_dir=os.path.join(root, "jax_cache"), **kw))
    ts = SR.SceneRepresentation(SR.SceneParams(
        cache_dir=os.path.join(root, "port_cache"), device="cpu", **kw))
    return js, ts


def box_object(path: str, oid: str, pos, scale=0.3) -> dict:
    obj = default_object_info()
    obj.update(object_name=oid, object_id=oid, object_path=path,
               pos=np.asarray(pos, np.float32), scale=scale)
    return obj


def insert_both(js, ts, obj, *edits):
    """Insert a copy of ``obj`` into each scene after each package's
    ``edits`` (DSL names taking the object)."""
    for scene, dsl in ((js, JEU), (ts, EU)):
        o = copy.deepcopy(obj)
        for name in edits:
            o = getattr(dsl, name)(o)
        dsl.insert_object(scene, o)


def unit_view_shading(surfels, env, env_sh, cam_center, base_color=None,
                      roughness=0.5, metallic=0.0, transform=None,
                      env_ggx=None, mirror_scene=None, emitter=None):
    """The JAX package's ``meshsplat.shaded_object_gaussians`` step for
    step from its own functions, with each view direction normalized by
    its own length."""
    j = jnp.asarray
    pts, nrm, cols = (j(surfels[k]) for k in ("points", "normals", "colors"))
    radius = float(surfels["radius"])
    if transform is not None:
        s, r, t = transform
        pts = apply_rotation(pts * s, r) + t
        nrm = apply_rotation(nrm, r)
        radius = radius * float(s)
    view = pts - cam_center[None, :]
    view = view / jnp.maximum(jnp.linalg.norm(view, axis=-1, keepdims=True),
                              1e-12)
    nrm_s = jnp.where(jnp.sum(nrm * view, -1, keepdims=True) > 0, -nrm, nrm)
    albedo = cols if base_color is None else cols * base_color
    if "roughness" in surfels:
        roughness = j(surfels["roughness"])[:, None]
    spec = mask = None
    if mirror_scene is not None:
        ndv = jnp.maximum(jnp.sum(nrm_s * (-view), -1, keepdims=True), 0.0)
        spec, hit = JIBL.mirror_scene_reflection(
            pts, 2.0 * ndv * nrm_s + view, *mirror_scene, env_sh)
        mask = hit[:, None]
    shaded = JIBL.shade(nrm_s, view, env, env_sh, albedo,
                        roughness=roughness, metallic=metallic,
                        env_ggx=env_ggx, scene_spec=spec,
                        scene_spec_mask=mask)
    if emitter is not None:
        from autovfx_tpu.render.emitter import emitter_irradiance

        shaded = shaded + albedo * emitter_irradiance(pts, nrm_s, emitter)
    return JMS.surfels_to_gaussians(pts, nrm_s, shaded, radius)


@contextlib.contextmanager
def jax_reference():
    """The JAX scene's passes with unit view directions in the object
    shading, rendered a frame per dispatch (``AUTOVFX_FRAMES_PER_DISPATCH``
    = 1, as its merged-object path always does) and each pass through a
    jitted ``rasterize``: the same functions, compiled once per shape
    instead of op by op."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMS, "shaded_object_gaussians", unit_view_shading)
        mp.setenv("AUTOVFX_FRAMES_PER_DISPATCH", "1")
        mp.setattr(JSR, "rasterize", jax.jit(JSR.rasterize,
                                              static_argnames=("config",)))
        yield


def frames_close(got, want, what=""):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d = np.abs(got - want).max(axis=-1)
    share = (d <= PIXEL_TOL).mean()
    assert share >= PIXEL_SHARE, (what, share)
    assert d.mean() <= MEAN_TOL, (what, d.mean())


def rb_close(got: dict, want: dict):
    """The two ``rb_transform`` dicts hold the same bodies and frames,
    positions and Euler angles within the physics goldens' bounds."""
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name], key=int) == sorted(want[name], key=int)
        frames = sorted(want[name], key=int)
        for key in ("pos", "rot", "scale"):
            a = np.array([got[name][f][key] for f in frames])
            b = np.array([want[name][f][key] for f in frames])
            assert np.abs(a - b).max() < TRAJ_TOL, (name, key)
            assert np.abs(a[-REST_FRAMES:] - b[-REST_FRAMES:]).max() \
                < REST_TOL, (name, key)


def normalized_config(path: str, cache: str) -> dict:
    with open(path) as f:
        text = f.read()
    return json.loads(text.replace(cache, "<cache>"))


def spy(scene, name: str, calls: list):
    """Record each return value of ``scene.<name>``."""
    fn = getattr(scene, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        calls.append(out)
        return out

    setattr(scene, name, wrapped)


@pytest.fixture(scope="module")
def drop(tmp_path_factory):
    """``tests/test_edit.py``'s drop edit through both packages, each
    ``render_scene`` once."""
    root = str(tmp_path_factory.mktemp("drop"))
    params = write_scene(root)
    js, ts = scenes(root, params)
    box = os.path.join(root, "ball.obj")
    JMIO.save_obj(box, box_mesh(0.5, color=(0.9, 0.1, 0.1)))
    insert_both(js, ts, box_object(box, "redbox01", [0.0, 0.0, 1.2]),
                "allow_physics")
    bg = {"jax": [], "port": []}
    spy(js, "render_from_3DGS", bg["jax"])
    spy(ts, "render_from_3DGS", bg["port"])
    with jax_reference():
        want = np.asarray(js.render_scene())
    got = ts.render_scene()
    return dict(root=root, params=params, js=js, ts=ts, want=want, got=got,
                bg=bg)


def test_scene_and_cameras_equal(drop):
    js, ts = drop["js"], drop["ts"]
    assert ts.gaussians.capacity == 400 and ts.total_frames == 4
    for f in ("xyz", "sh_dc", "sh_rest", "log_scales", "quats",
              "opacity_logit", "active"):
        np.testing.assert_allclose(getattr(ts.gaussians, f).numpy(),
                                   np.asarray(getattr(js.gaussians, f)),
                                   rtol=0, atol=1e-6)
    for f in ("R", "t", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(ts.cameras, f).numpy(),
                                   np.asarray(getattr(js.cameras, f)),
                                   rtol=0, atol=1e-6)
    assert (ts.cameras.width, ts.cameras.height) == (64, 48)
    np.testing.assert_allclose(ts.c2w, js.c2w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.camera_position, js.camera_position,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.camera_rotation, js.camera_rotation,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("frame", range(4))
def test_render_from_3dgs_matches_jax(drop, frame):
    want, got = drop["bg"]["jax"][0], drop["bg"]["port"][0]
    for w, g in zip(want, got):  # colors, depths, alphas
        assert g.device.type == "cpu" and g.shape == w.shape
    a, b = got[0][frame].double().numpy(), np.asarray(want[0][frame], np.float64)
    mse = np.mean((a - b) ** 2)
    assert -10.0 * np.log10(max(mse, 1e-30)) > 90.0
    assert got[2][frame].max() > 0.3


def test_drop_edit_frames_match_jax(drop):
    got, want = drop["got"], drop["want"]
    assert torch.is_tensor(got) and got.shape == (4, 48, 64, 3)
    assert torch.isfinite(got).all()
    for i in range(4):
        frames_close(got[i], want[i], f"frame {i}")
    # the object shows: the edited frames differ from the background
    bg = drop["bg"]["port"][0]
    assert (got - bg[0].clamp(0, 1)).abs().amax(-1).gt(0.1).sum() > 20


def test_drop_edit_rb_transform_matches_jax(drop):
    got, want = drop["ts"].rb_transform, drop["js"].rb_transform
    rb_close(got, want)
    assert got["redbox01"]["3"]["pos"][2] < got["redbox01"]["0"]["pos"][2]


def test_drop_edit_writes_frames_and_config(drop):
    ts, js = drop["ts"], drop["js"]
    root = drop["root"]
    blended = os.path.join(ts.blender_output_dir, "blended")
    assert sorted(os.listdir(blended)) == [f"{i:04d}.png" for i in range(4)]
    got = normalized_config(os.path.join(ts.cache_dir, "edit_config.json"),
                            os.path.join(root, "port_cache"))
    want = normalized_config(os.path.join(js.cache_dir, "edit_config.json"),
                             os.path.join(root, "jax_cache"))
    rb_close(got.pop("rb_transform"), want.pop("rb_transform"))
    assert got == want


def test_drop_edit_stays_within_the_budget(drop):
    assert not bool(drop["ts"].overflowed)


def test_overflow_is_flagged_at_a_small_budget(drop, tmp_path):
    """At ``tests/test_edit.py``'s 2^14 duplicates the object pass
    overflows; the scene says so."""
    ts = SR.SceneRepresentation(SR.SceneParams(
        cache_dir=str(tmp_path), device="cpu",
        **dict(drop["params"], dup_budget=1 << 14)))
    ts.inserted_objects = copy.deepcopy(drop["ts"].inserted_objects)
    ts.render_from_3DGS(frame_indices=[0])
    assert not bool(ts.overflowed)
    ts.run_physics()
    ts.render_object_pass(0)
    assert bool(ts.overflowed)


def test_render_from_3dgs_takes_a_range_or_array_where_the_reference_raises(
        drop):
    """The reference's ``frame_indices or list(...)``
    (``scene_representation.py:652``) with its list concatenation
    (``:703``) raises for a ``range`` (no ``+`` with a list) and an
    ndarray (no truth value); the port takes any iterable of ints."""
    js, ts = drop["js"], drop["ts"]
    with pytest.raises(TypeError):
        js.render_from_3DGS(frame_indices=range(1, 3))
    with pytest.raises(ValueError):
        js.render_from_3DGS(frame_indices=np.array([1, 2]))
    full = drop["bg"]["port"][0]
    for idx in (range(1, 3), np.array([1, 2]), [1, 2]):
        c, d, a = ts.render_from_3DGS(frame_indices=idx)
        assert torch.equal(c, full[0][1:3]) and torch.equal(a, full[2][1:3])


# ---- the time-varying edits' cases (tests/test_torch_edit_*.py) ---------------


def run_edit(tmp_path_factory, name, pos, edits, after=None, n_cams=4):
    """One cube at ``pos`` with the DSL ``edits`` (and ``after(js, ts)``,
    e.g. events) through both packages' ``render_scene`` over ``n_cams``
    frames: (JAX scene, port scene, JAX frames, port frames)."""
    root = str(tmp_path_factory.mktemp(name))
    js, ts = scenes(root, write_scene(root, n_cams))
    box = os.path.join(root, "box.obj")
    JMIO.save_obj(box, box_mesh(0.5, color=(0.3, 0.6, 0.9)))
    insert_both(js, ts, box_object(box, "cube01", pos), "allow_physics",
                *edits)
    if after is not None:
        after(js, ts)
    with jax_reference():
        want = np.asarray(js.render_scene(save=False))
    got = ts.render_scene(save=False)
    return js, ts, want, got


def same_fragments(js, ts):
    """The same 8 fragments per broken object: ids, ``visible_from``,
    faces equal, vertices within 1e-6."""
    assert sorted(ts._fragments) == sorted(js._fragments)
    for oid, pieces in js._fragments.items():
        got = ts._fragments[oid]
        assert len(got) == len(pieces) == 8
        for a, b in zip(got, pieces):
            assert a["visible_from"] == b["visible_from"]
            assert a["object"]["object_id"] == b["object"]["object_id"]
            np.testing.assert_array_equal(a["faces"], b["faces"])
            np.testing.assert_allclose(a["vertices"], b["vertices"],
                                       rtol=0, atol=1e-6)
