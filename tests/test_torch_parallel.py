"""The port's parallel layer against the JAX package's, on the CPU.

For each world size D (2 and 4), one module-scoped spawn of D gloo ranks
(``autovfx_tpu_torch.parallel.launch.spawn``) runs every case of
``tests/torch_parallel_ranks.py`` (torch only) on seeded inputs made by
JAX, and the results are held against JAX's functions over its virtual
mesh (``devices=jax.devices()[:D]``; ``tests/conftest.py`` gives 8),
as its recordings ``parallel_D2`` and ``parallel_D4`` hold them:

- ``make_mesh``: shapes and each rank's coordinates;
- ``dp_train_step``: loss and PSNR rtol 1e-4, the state after the step
  within 5e-4 of each field's largest, the densify stats;
- ``dp_train`` with densify and a checkpoint: replicated on every rank,
  the checkpoint written once;
- the slab paths (full capacity, compact, the distributed build) and
  the trajectory: composites at ``tests/test_parallel.py``'s bounds
  (color and alpha atol 2e-3, depth 5e-3), slab membership equal away
  from the quantile boundaries, ``round_robin_store`` equal, the
  overflow and pair-overflow flags, the reshard count;
- the dry run's body in each world, and ``dryrun_multichip`` itself.
"""
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu.parallel import sharding as JS
from autovfx_tpu.parallel.mesh import make_mesh as j_make_mesh
from autovfx_tpu.utils.synthetic import make_scene
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.parallel import dryrun, launch
from autovfx_tpu_torch.parallel import sharding as S

import torch_parallel_ranks
import torch_references as REF

CFG = RasterConfig(dup_budget=1 << 13, backend="ref")
COLOR_ATOL, DEPTH_ATOL = 2e-3, 5e-3
LOSS_RTOL, STATE_TOL = 1e-4, 5e-4
BOUNDARY_REL = 1e-5  # a splat this near a slab boundary may go either way
LOOP_CFG = dict(iterations=12, densify_from_iter=2, densify_until_iter=12,
                densification_interval=5, opacity_reset_interval=10**9,
                spatial_lr_scale=2.0)


def g_arrays(g):
    return {f: np.asarray(getattr(g, f)) for f in convert.GAUSSIAN_FIELDS}


def cam_arrays(cam):
    return {f: (np.asarray(getattr(cam, f)) if f not in ("width", "height")
                else getattr(cam, f)) for f in convert.CAMERA_FIELDS}


def ring_cams(n, w=32, h=24):
    return JC.stack_cameras([
        JC.look_at_camera([3 * np.cos(a), 3 * np.sin(a), 1.0], [0, 0, 0],
                          [0, 0, 1], fx=28.0, fy=28.0, width=w, height=h)
        for a in np.linspace(0, 2 * np.pi, n, endpoint=False)])


def orbit(angles):
    return JC.stack_cameras([
        JC.look_at_camera([3 * np.cos(a), 3 * np.sin(a), 1.0], [0, 0, 0],
                          [0, 0, 1], fx=28.0, fy=28.0, width=32, height=24)
        for a in angles])


def close_field(got, want, tol, what):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    err = np.abs(b - a).max() / (np.abs(a).max() + 1e-6)
    assert err < tol, (what, err)


def assert_render(got, color, depth, alpha):
    np.testing.assert_allclose(got["color"], np.asarray(color),
                               atol=COLOR_ATOL, rtol=0)
    np.testing.assert_allclose(got["alpha"], np.asarray(alpha),
                               atol=COLOR_ATOL, rtol=0)
    np.testing.assert_allclose(got["depth"], np.asarray(depth),
                               atol=DEPTH_ATOL, rtol=0)


# one device's JAX render, compiled once per shape for both worlds
render = jax.jit(lambda g, c, bg: rasterize(g, c, bg=bg, config=CFG))


def world_inputs(d: int):
    """The JAX-made scenes, cameras and background of a world of ``d``
    ranks, and their digest: the DP step's perturbed scene toward its
    renders, and the slabs' scene (the JAX distributed test's)."""
    g, _ = make_scene(n=100, width=32, height=24, key=1)
    scene, cam = make_scene(n=256, width=32, height=24, key=3)
    inp = dict(
        g=g, cams=ring_cams(d), bg=jnp.array([0.3, 0.2, 0.1]),
        g_train=g.replace(xyz=g.xyz + 0.03 * jax.random.normal(
            jax.random.PRNGKey(2), g.xyz.shape)),
        scene=scene, cam=cam, traj=orbit((0.0, 0.06, np.pi)))
    return inp, REF.digest(dict(inp, d=d, cfg=CFG))


def dp_images(jin: dict, d: int):
    """The DP step's targets: the unperturbed scene's renders."""
    return jnp.stack([render(jin["g"], JC.index_camera(jin["cams"], i),
                             0 * jin["bg"]).color for i in range(d)])


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def world(request, tmp_path_factory):
    """(D, the JAX side's results, every rank's results, the checkpoint
    path).  What the JAX side runs under ``jax.jit`` over
    ``jax.devices()[:D]`` is its recording ``parallel_D<D>``; the scenes,
    the one-device renders, the host-side slabs and the 2×2 mesh are
    made live."""
    d = request.param
    jin, key = world_inputs(d)
    scene, cam, bg = jin["scene"], jin["cam"], jin["bg"]
    full = JS.shard_gaussians(scene, cam, d)
    compact, c_ovf = JS.shard_gaussians_compact(scene, cam, d, slack=0.5)
    flat = scene.replace(xyz=jnp.zeros_like(scene.xyz))
    traj = jin["traj"]
    jax_side = dict(
        REF.load(f"parallel_D{d}", key), scene=scene, cam=cam,
        single=render(scene, cam, bg),
        full_slabs=g_arrays(full), compact_slabs=g_arrays(compact),
        compact_overflow=bool(c_ovf),
        store=g_arrays(JS.round_robin_store(scene, d)),
        flat_overflow=bool(JS.shard_gaussians_compact(flat, cam, d,
                                                      slack=0.0)[1]),
        traj=[render(scene, JC.index_camera(traj, f), 0 * bg).color
              for f in range(3)],
        mesh_2d=(j_make_mesh((2, 2), devices=jax.devices()[:d])
                 if d == 4 else None))
    ckpt = str(tmp_path_factory.mktemp(f"dp{d}") / "dp.npz")
    inp = {
        "budget": CFG.dup_budget, "cams": cam_arrays(jin["cams"]),
        "images": np.asarray(dp_images(jin, d)),
        "train_g": g_arrays(jin["g_train"]),
        "loop_g": g_arrays(jin["g_train"].pad_to(160)), "loop_cfg": LOOP_CFG,
        "cam_order": np.random.default_rng(d).integers(0, d, (12, d)),
        "ckpt": ckpt, "scene": g_arrays(jin["scene"]),
        "cam": cam_arrays(jin["cam"]), "bg": np.asarray(jin["bg"]),
        "slack": 0.5, "dist_slack": 0.6,
        "jax_full_slabs": jax_side["full_slabs"],
        "jax_compact_slabs": jax_side["compact_slabs"],
        "traj": cam_arrays(jin["traj"]), "traj_frames": 3,
    }
    ranks = launch.spawn(d, torch_parallel_ranks.run_cases, (inp,),
                         backend="gloo", device="cpu")
    return d, jax_side, ranks, ckpt


def test_make_mesh(world):
    d, jax_side, ranks, _ = world
    for r, out in enumerate(ranks):
        shape, coords = out["mesh_default"]
        assert shape == dict(j_make_mesh(devices=jax.devices()[:d]).shape)
        assert coords == {"data": r, "gauss": 0}
    if d == 4:
        jdev = np.vectorize(lambda x: x.id)(jax_side["mesh_2d"].devices)
        for r, out in enumerate(ranks):
            shape, coords, lines = out["mesh_2d"]
            assert shape == dict(jax_side["mesh_2d"].shape)
            assert jdev[coords["data"], coords["gauss"]] == r
            assert list(lines["gauss"]) == list(jdev[coords["data"]])
            assert list(lines["data"]) == list(jdev[:, coords["gauss"]])


def test_dp_step_matches_jax(world):
    _, jax_side, ranks, _ = world
    jstate, jaux = jax_side["dp"]["state"], jax_side["dp"]["aux"]
    got = ranks[0]["dp"]
    np.testing.assert_allclose(got["loss"], float(jaux["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["psnr"], float(jaux["psnr"]),
                               rtol=LOSS_RTOL)
    assert got["overflow"] is bool(jaux["overflow"]) is False
    for prefix in ("g_", "m_", "v_"):
        for f in ("xyz", "sh_dc", "sh_rest", "log_scales", "quats",
                  "opacity_logit"):
            close_field(got[prefix + f], jstate[prefix + f], STATE_TOL,
                        prefix + f)
    np.testing.assert_array_equal(got["stats_max_radii"],
                                  jstate["stats_max_radii"])
    np.testing.assert_array_equal(got["stats_denom"], jstate["stats_denom"])
    close_field(got["stats_grad_accum"], jstate["stats_grad_accum"], 1e-4,
                "grad_accum")
    # the state is replicated: every rank holds the same numbers
    for other in ranks[1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(other["dp"][k], v, err_msg=k)


def test_dp_train_densifies_and_checkpoints(world):
    d, _, ranks, ckpt = world
    loop = ranks[0]["loop"]
    hist = loop["history"]
    assert [h["iter"] for h in hist] == list(range(1, 13))
    assert all(np.isfinite(h["loss"]) for h in hist)
    # densify at step 5 and 10 grew the 100 live splats
    assert hist[-1]["active"] != 100 and hist[0]["active"] == 100
    assert int(loop["g_active"].sum()) == hist[-1]["active"]
    for other in ranks[1:]:
        assert other["loop"]["history"] == hist
        for k, v in loop.items():
            if k != "history":
                np.testing.assert_array_equal(other["loop"][k], v, err_msg=k)
    # written by the first rank alone, at the last step
    assert ranks[0]["ckpt_step"] == 12
    assert glob.glob(os.path.join(os.path.dirname(ckpt), "*")) == [ckpt]


def _scene_depths(jax_side):
    scene, cam = jax_side["scene"], jax_side["cam"]
    z = (np.asarray(scene.xyz, np.float64) @ np.asarray(cam.R, np.float64)[2]
         + float(cam.t[2]))
    return z, np.asarray(scene.xyz)


def _rows(arrs, r=None):
    """The set of xyz rows of a slab's active splats (slab ``r`` of
    stacked arrays)."""
    pick = (lambda a: np.asarray(a)[r]) if r is not None else np.asarray
    act = pick(arrs["active"])
    return {tuple(x) for x in pick(arrs["xyz"])[act].tolist()}


def test_slab_membership_matches_jax(world):
    """Quantile slabs (full capacity and compact) equal JAX's away from
    the quantile boundaries; the distributed build's equal JAX's away
    from its histogram bins' edges."""
    d, jax_side, ranks, _ = world
    z, xyz = _scene_depths(jax_side)
    slab = np.asarray(JS.assign_depth_slabs(jax_side["scene"],
                                            jax_side["cam"], d))
    bounds = np.sort(z)[(np.arange(1, d) * len(z)) // d]
    near = np.any(np.abs(z[:, None] - bounds[None]) <= BOUNDARY_REL * (
        1 + np.abs(bounds[None])), axis=1)
    pos = (z - z.min()) / (z.max() - z.min()) * 512
    near_bin = np.abs(pos - np.round(pos)) < 1e-3
    port = S.assign_depth_slabs(
        convert.gaussians(g_arrays(jax_side["scene"]), device="cpu"),
        convert.camera(cam_arrays(jax_side["cam"]), device="cpu"), d).numpy()
    np.testing.assert_array_equal(port[~near], slab[~near])
    # each boundary is a splat's depth; the extremes sit on bin edges
    assert near.sum() <= 2 * (d - 1) and near_bin.sum() <= 8
    free = {tuple(x) for x in xyz[near].tolist()}
    free_bin = {tuple(x) for x in xyz[near_bin].tolist()}
    for r, out in enumerate(ranks):
        want = {tuple(x) for x in xyz[slab == r].tolist()} - free
        assert _rows(out["full_slab"]) - free == want, r
        assert _rows(out["compact_slab"]) - free == want, r
        assert (_rows(out["full_slab"]) - free
                == _rows(jax_side["full_slabs"], r) - free)
        assert (_rows(out["dist_slab"]) - free_bin
                == _rows(jax_side["dist_slabs"], r) - free_bin)


@pytest.mark.parametrize("path", ["full", "compact", "dist"])
def test_slab_composites_match_jax(world, path):
    _, jax_side, ranks, _ = world
    single = jax_side["single"]
    for out in ranks:
        assert_render(out[path], *jax_side[path])
        assert_render(out[path], single.color, single.depth, single.alpha)
        if path != "dist":  # the port's composite of JAX's own slabs
            assert_render(out[path + "_of_jax"], *jax_side[path])


def test_store_and_overflow_flags_match_jax(world):
    d, jax_side, ranks, _ = world
    for r, out in enumerate(ranks):
        want = {k: np.asarray(v)[r] for k, v in jax_side["store"].items()}
        for k in want:
            np.testing.assert_array_equal(out["store"][k], want[k], err_msg=k)
        assert out["compact_overflow"] == jax_side["compact_overflow"]
        assert out["dist_overflow"] == jax_side["dist_overflow"] is False
        assert out["flat_overflow"] == jax_side["flat_overflow"] is True
        assert out["flat_pair_overflow"] == jax_side["flat_pair_overflow"]
        assert out["flat_pair_overflow"] is True
        # the distributed build keeps ~M (1 + slack) rows a rank, not N
        assert len(out["dist_slab"]["xyz"]) < 256 * 1.6 / d + 8 * d
    total = sum(int(out["dist_slab"]["active"].sum()) for out in ranks)
    assert total == int(np.asarray(jax_side["scene"].active).sum())


def test_trajectory_matches_jax(world):
    """A gentle step rides the anchor's slabs, the jump builds them
    again (``tests/test_parallel.py``'s counts); a frame at its own slabs
    is the single render's, a frame at the anchor's within the JAX test's
    mean 0.02 of it."""
    _, jax_side, ranks, _ = world
    for out in ranks:
        assert out["traj"]["reshards"] == 2
        frames = out["traj"]["frames"]
        for f, want in enumerate(jax_side["traj"]):
            if f == 1:
                assert np.abs(frames[f] - np.asarray(want)).mean() < 0.02
            else:
                np.testing.assert_allclose(frames[f], np.asarray(want),
                                           atol=COLOR_ATOL, rtol=0)


def test_dryrun_body_in_each_world(world):
    d, _, ranks, _ = world
    for out in ranks:
        res = out["dryrun"]
        assert res["loss"] > 1e-5 and res["dxyz"] > 0
        for name in ("full", "compact", "distributed"):
            assert res[name][0] <= COLOR_ATOL and res[name][2] <= DEPTH_ATOL
        assert res["build_mean_err"] < dryrun.BUILD_MEAN_ERR


def test_dryrun_multichip():
    res = dryrun.dryrun_multichip(2, device="cpu")
    assert res["loss"] > 1e-5 and res["build_mean_err"] < 5e-3


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch.spawn(2, torch_parallel_ranks.fail_on_rank_1, (),
                     backend="gloo", device="cpu")


def one_rank_build(rank: int, world: int, inp: dict) -> dict:
    """The rank side of the D = 1 pin (torch and the port only): the
    distributed build of the store and its composite, and the single
    render of the same scene."""
    import torch

    from autovfx_tpu_torch.ops.rasterize import RasterConfig as PConfig
    from autovfx_tpu_torch.ops.rasterize import rasterize as p_rasterize
    from autovfx_tpu_torch.parallel.mesh import make_mesh

    config = PConfig(dup_budget=inp["budget"])
    g = convert.gaussians(inp["scene"], device="cpu")
    cam = convert.camera(inp["cam"], device="cpu")
    bg = torch.from_numpy(inp["bg"])
    mesh = make_mesh((1, 1), backend="gloo", device="cpu")
    built, ovf = S.distributed_shard_compact(
        S.round_robin_store(g, world, rank), cam, mesh, slack=inp["slack"])
    color, depth, alpha = S.sharded_render_compact(built, cam, mesh, config,
                                                   bg)
    want = p_rasterize(g, cam, bg=bg, config=config)
    return {"overflow": bool(ovf), "active": int(built.active.sum()),
            "got": (color.numpy(), depth.numpy(), alpha.numpy()),
            "want": (want.color.numpy(), want.depth.numpy(),
                     want.alpha.numpy())}


def test_distributed_build_at_one_rank_where_the_reference_raises():
    """At D = 1 the reference's window, ``cap_pair`` = ⌈1.3 M⌉ rounded up
    to 8 rows (``autovfx_tpu/parallel/sharding.py:497-498``), is longer
    than the store, and its ``dynamic_slice`` refuses it; the port pads
    the sorted rows up to the window, so its build plus render is the
    single ``rasterize`` (alpha as 1 - (1 - alpha): within 1.2e-7)."""
    scene, cam = make_scene(n=64, width=32, height=24, key=3)
    bg = jnp.array([0.3, 0.2, 0.1])
    mesh = j_make_mesh((1, 1), devices=jax.devices()[:1])
    store = JS.round_robin_store(scene, 1)
    with pytest.raises(TypeError, match="slice_sizes"):
        jax.jit(lambda st: JS.distributed_shard_compact(
            st, cam, mesh, slack=0.6))(store)

    inp = {"budget": CFG.dup_budget, "scene": g_arrays(scene),
           "cam": cam_arrays(cam), "bg": np.asarray(bg), "slack": 0.6}
    (out,) = launch.spawn(1, one_rank_build, (inp,), backend="gloo",
                          device="cpu")
    assert out["overflow"] is False and out["active"] == 64
    (color, depth, alpha), (w_color, w_depth, w_alpha) = out["got"], out["want"]
    np.testing.assert_array_equal(color, w_color)
    np.testing.assert_array_equal(depth, w_depth)
    np.testing.assert_allclose(alpha, w_alpha, rtol=0, atol=1.2e-7)
