"""SuGaR's mesh extraction in the PyTorch port vs the JAX package, on the
CPU.

The scene is ``tests/test_sugar.py``'s 600-splat sphere shell seen by 4
cameras at 64×48 (``torch_sugar_common``); the JAX package's device
functions run under ``jax.jit``.  Budgets:

- the copied ``marching`` module: identical meshes;
- ``_nearest_gaussian``: identical indices;
- ``level_surface_from_camera``: valid masks equal on ≥ 99.5 % of the
  rays, points within 1e-4 on the rays valid in both;
- ``tsdf_fuse`` from the same depth maps: the field within 1e-5;
- the meshes of the FFT and scatter paths (``poisson_reconstruct``,
  ``tsdf_mesh``, ``density_grid_mesh``, ``extract_mesh_from_gaussians``
  at resolution 24-32): vertex and face counts within 1 %, and every
  port vertex within 1e-3 of the JAX mesh's box extent of a JAX vertex,
  but for the vertices a density-quantile prune keeps in one package
  and drops in the other (a rounding apart at its threshold): these
  count against the 1 %, and each lies within a voxel diagonal.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.sugar import extract_mesh as JEM
from autovfx_tpu.sugar import levelset as JLS
from autovfx_tpu.sugar import marching as JMT
from autovfx_tpu.sugar import poisson as JPO
from autovfx_tpu.sugar import sdf_fusion as JSF
from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.sugar import extract_mesh as EM
from autovfx_tpu_torch.sugar import levelset as LS
from autovfx_tpu_torch.sugar import marching as MT
from autovfx_tpu_torch.sugar import poisson as PO
from autovfx_tpu_torch.sugar import sdf_fusion as SF
from torch_sugar_common import (
    JCFG,
    PCFG,
    close,
    jax_gaussians,
    nearest_distance,
    port_camera,
    port_gaussians,
    ring,
    shell_arrays,
)

LEVEL_AGREE = 0.995
POINT_TOL = 1e-4
MESH_TOL = 1e-3  # of the JAX mesh's box extent
COUNT_TOL = 0.01
BOX = ([-1.4] * 3, [1.4] * 3)

_level_set = jax.jit(JLS.level_surface_from_camera,
                     static_argnames=("config", "level", "pixel_stride", "k"))


def meshes_close(got, want, what: str, resolution: int) -> None:
    """Counts within 1 %; every port vertex within 1e-3 of the extent of
    a JAX vertex, but for the ones a density-quantile prune kept in one
    package and dropped in the other (a count difference: at most 1 % of
    the vertices, each within a voxel diagonal of the JAX mesh)."""
    (v, f), (vj, fj) = got, want
    assert len(vj) > 100 and len(fj) > 100, f"{what}: the JAX mesh is empty"
    assert abs(len(v) - len(vj)) <= COUNT_TOL * len(vj), (
        f"{what}: {len(v)} vertices, JAX {len(vj)}")
    assert abs(len(f) - len(fj)) <= COUNT_TOL * len(fj), (
        f"{what}: {len(f)} faces, JAX {len(fj)}")
    extent = float(np.max(vj.max(0) - vj.min(0)))
    dist = nearest_distance(v, vj)
    far = dist > MESH_TOL * extent
    assert far.sum() <= COUNT_TOL * len(vj), (
        f"{what}: {far.sum()} vertices farther than {MESH_TOL} of the extent")
    voxel = 1.3 * extent / (resolution - 1) * np.sqrt(3.0)
    assert float(dist.max()) <= voxel, f"{what}: a vertex {dist.max():.3g} away"


@pytest.fixture(scope="module")
def scene():
    # the JAX extraction's level sets under jit (its callers import the
    # function at call time, or at module level in extract_mesh)
    patch = pytest.MonkeyPatch()
    jitted = lambda g, cam, **k: _level_set(g, cam, **k)
    patch.setattr(JLS, "level_surface_from_camera", jitted)
    patch.setattr(JEM, "level_surface_from_camera", jitted)
    a = shell_arrays()
    cams = ring(4)
    yield dict(a=a, g=jax_gaussians(a), pg=port_gaussians(a), cams=cams,
               jstack=JC.stack_cameras(cams),
               pstack=C.stack_cameras([port_camera(c) for c in cams]))
    patch.undo()


def test_marching_copy_is_identical():
    xs = np.linspace(-1, 1, 20)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    vals = (0.7 - np.sqrt(gx**2 + gy**2 + gz**2 + 0.1 * gx * gy)).astype(
        np.float32)
    for level in (0.0, 0.2):
        v, f = MT.marching_tetrahedra(vals, level, [-1, -1, -1], xs[1] - xs[0])
        vj, fj = JMT.marching_tetrahedra(vals, level, [-1, -1, -1],
                                         xs[1] - xs[0])
        np.testing.assert_array_equal(v, vj)
        np.testing.assert_array_equal(f, fj)
    v2, f2 = MT.decimate_vertex_clustering(v, f, len(v) // 3)
    v2j, f2j = JMT.decimate_vertex_clustering(vj, fj, len(vj) // 3)
    np.testing.assert_array_equal(v2, v2j)
    np.testing.assert_array_equal(f2, f2j)


def test_nearest_gaussian_indices(scene):
    rng = np.random.default_rng(3)
    q = (1.3 * rng.standard_normal((500, 3))).astype(np.float32)
    want, _ = jax.jit(JLS._nearest_gaussian)(jnp.asarray(q), scene["g"])
    got = LS._nearest_gaussian(torch.as_tensor(q), scene["pg"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def level_sets(scene):
    """(port, JAX) level-set points of camera 0 and 2."""
    out = []
    for i in (0, 2):
        want = _level_set(scene["g"], scene["cams"][i], config=JCFG)
        got = LS.level_surface_from_camera(
            scene["pg"], port_camera(scene["cams"][i]), config=PCFG)
        out.append((got, want))
    return out


def test_level_surface_from_camera(level_sets):
    for got, want in level_sets:
        v, vj = got.valid.numpy(), np.asarray(want.valid)
        assert vj.sum() > 100
        assert (v == vj).mean() >= LEVEL_AGREE
        both = v & vj
        assert float(np.abs(got.points.numpy()[both]
                            - np.asarray(want.points)[both]).max()) <= POINT_TOL
        assert float(np.abs(got.normals.numpy()[both]
                            - np.asarray(want.normals)[both]).max()) <= 1e-3


@pytest.fixture(scope="module")
def level_cloud(level_sets):
    """The JAX level-set cloud of the two cameras, outliers removed."""
    pts = np.concatenate([np.asarray(w.points)[np.asarray(w.valid)]
                          for _, w in level_sets])
    nrm = np.concatenate([np.asarray(w.normals)[np.asarray(w.valid)]
                          for _, w in level_sets])
    return pts, nrm


def test_remove_outliers(level_cloud):
    pts, nrm = level_cloud
    pts = np.concatenate([pts, [[5.0, 5.0, 5.0]]]).astype(np.float32)
    nrm = np.concatenate([nrm, [[0.0, 0.0, 1.0]]]).astype(np.float32)
    p, n = EM.remove_outliers(pts, nrm, device="cpu")
    pj, nj = JEM.remove_outliers(pts, nrm)
    np.testing.assert_array_equal(p, pj)
    np.testing.assert_array_equal(n, nj)
    assert len(p) < len(pts)


def test_poisson_reconstruct(level_cloud):
    pts, nrm = level_cloud
    lo, hi = np.percentile(pts, 1, axis=0), np.percentile(pts, 99, axis=0)
    got = PO.poisson_reconstruct(pts, -nrm, lo, hi, resolution=32,
                                 device="cpu")
    want = JPO.poisson_reconstruct(pts, -nrm, lo, hi, resolution=32)
    meshes_close(got, want, "poisson", 32)


def test_tsdf_fuse_and_mesh(scene):
    sub, depths, valids = JSF.render_depth_maps(
        scene["g"], scene["jstack"], config=JCFG, every_nth=2)
    psub = C.stack_cameras([port_camera(JC.index_camera(sub, i))
                            for i in range(JC.num_cameras(sub))])
    phi, band = SF.tsdf_fuse(psub, depths, valids, *BOX, resolution=24,
                             return_weights=True)
    phi_j, band_j = JSF.tsdf_fuse(sub, depths, valids, *BOX, resolution=24,
                                  return_weights=True)
    close(phi, phi_j, what="tsdf")
    np.testing.assert_array_equal(band, band_j)
    # the port's own depth maps, and its whole TSDF mesh
    _, d2, v2 = SF.render_depth_maps(scene["pg"], scene["pstack"],
                                     config=PCFG, every_nth=2)
    ok = (d2 < 1e9) & (depths < 1e9)
    assert (ok == (depths < 1e9)).mean() >= LEVEL_AGREE
    assert float(np.abs(d2[ok] - depths[ok]).max()) <= POINT_TOL * 10
    got = SF.tsdf_mesh(scene["pg"], scene["pstack"], *BOX, config=PCFG,
                       resolution=24, every_nth=2)
    want = JSF.tsdf_mesh(scene["g"], scene["jstack"], *BOX, config=JCFG,
                         resolution=24, every_nth=2)
    meshes_close(got, want, "tsdf mesh", 24)


def test_density_grid_mesh(scene):
    got = EM.density_grid_mesh(scene["pg"], *BOX, resolution=24,
                               chunk=1 << 12)
    want = JEM.density_grid_mesh(scene["g"], *BOX, resolution=24,
                                 chunk=1 << 12)
    meshes_close(got, want, "density grid", 24)


def test_extract_mesh_from_gaussians(scene, tmp_path, monkeypatch):
    """The whole extraction from one level-set cloud (JAX's: a ray whose
    crossing one package finds and the other misses adds a sample, and
    the density-quantile prunes then keep or drop a vertex an edge away),
    with a vertex target above the mesh (quadric decimation, a copied
    numpy module, picks its collapses from float ties)."""
    clouds = []
    real = JEM.extract_level_points
    monkeypatch.setattr(JEM, "extract_level_points",
                        lambda *a, **k: clouds.append(real(*a, **k))
                        or clouds[-1])
    kw = dict(config=None, fg_resolution=32, bg_resolution=16,
              target_vertices=50_000)
    want = JEM.extract_mesh_from_gaussians(
        scene["g"], scene["jstack"], **dict(kw, config=JCFG))
    own = EM.extract_level_points(scene["pg"], scene["pstack"], config=PCFG)
    assert abs(len(own[0]) - len(clouds[0][0])) <= (1 - LEVEL_AGREE) * len(
        clouds[0][0])
    monkeypatch.setattr(EM, "extract_level_points", lambda *a, **k: clouds[0])
    got = EM.extract_mesh_from_gaussians(
        scene["pg"], scene["pstack"], out_path=str(tmp_path / "m.obj"),
        **dict(kw, config=PCFG))
    meshes_close((got.vertices, got.faces), (want.vertices, want.faces),
                 "extracted", 32)
    assert np.isfinite(got.vertex_colors).all()
    assert (tmp_path / "m.obj").exists()
