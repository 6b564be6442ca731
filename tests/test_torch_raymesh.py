"""The port's ray-mesh casting and init points against the JAX package's,
on the CPU.

- ``ray_mesh_first_hit``: the hit triangle equal on ≥ 99.9 % of rays, t
  within 1e-5 relative where both hit;
- ``build_init_points`` in each mode (``colmap``, ``ray_mesh``,
  ``hybrid``): the same pixel draws, so the same rays, points within
  1e-5 and colors equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.ops.raymesh import ray_mesh_first_hit as j_first_hit
from autovfx_tpu.train import init_points as JIP
from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.ops.raymesh import ray_mesh_first_hit
from autovfx_tpu_torch.train import init_points as IP


@pytest.fixture(scope="module")
def mesh():
    """A seeded bumpy 20×20 height field: (vertices, faces)."""
    rng = np.random.default_rng(0)
    g = np.linspace(-1.5, 1.5, 20)
    x, y = np.meshgrid(g, g)
    z = 0.3 * rng.random(x.shape)
    v = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(400).reshape(20, 20)
    a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    f = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                        np.stack([a, d, c], -1).reshape(-1, 3)])
    return v, f.astype(np.int64)


@pytest.mark.parametrize("tri_chunk", [4096, 100])
def test_ray_mesh_first_hit_matches_jax(mesh, tri_chunk):
    v, f = mesh
    tri = [v[f[:, i]] for i in range(3)]
    rng = np.random.default_rng(1)
    o = np.concatenate([rng.random((3000, 2)) * 3.6 - 1.8,
                        np.full((3000, 1), 2.0)], 1).astype(np.float32)
    d = (rng.standard_normal((3000, 3)) * [0.3, 0.3, 1.0]).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t, idx, hit = ray_mesh_first_hit(torch.tensor(o), torch.tensor(d),
                                     *map(torch.tensor, tri),
                                     tri_chunk=tri_chunk)
    jt, jidx, jhit = j_first_hit(jnp.asarray(o), jnp.asarray(d),
                                 *map(jnp.asarray, tri), tri_chunk=tri_chunk)
    jt, jidx, jhit = map(np.asarray, (jt, jidx, jhit))
    assert (idx.numpy() == jidx).mean() >= 0.999
    assert (hit.numpy() == jhit).mean() >= 0.999
    assert 0.3 < jhit.mean() < 1.0
    both = hit.numpy() & jhit
    rel = np.abs(t.numpy()[both] - jt[both]) / np.abs(jt[both])
    assert rel.max() <= 1e-5


@pytest.fixture(scope="module")
def views(mesh):
    """Two cameras looking down at the mesh and seeded images."""
    kw = dict(fx=40.0, fy=40.0, width=48, height=32)
    eyes = ([1.5, 0.3, 2.5], [-1.2, -0.8, 2.2])
    cams = C.stack_cameras([C.look_at_camera(e, [0, 0, 0], [0, 0, 1],
                                             device="cpu", **kw)
                            for e in eyes])
    jcams = JC.stack_cameras([JC.look_at_camera(e, [0, 0, 0], [0, 0, 1],
                                                **kw) for e in eyes])
    images = np.random.default_rng(2).random((2, 32, 48, 3)).astype(
        np.float32)
    return cams, jcams, images


@pytest.mark.parametrize("strategy", ["colmap", "ray_mesh", "hybrid"])
def test_build_init_points_matches_jax(mesh, views, strategy):
    cams, jcams, images = views
    rng = np.random.default_rng(3)
    sfm_xyz = rng.random((300, 3)).astype(np.float32)
    sfm_rgb = rng.random((300, 3)).astype(np.float32)
    got = IP.build_init_points(strategy, sfm_xyz, sfm_rgb, cams, images,
                               *mesh, seed=4, device="cpu")
    want = JIP.build_init_points(strategy, sfm_xyz, sfm_rgb, jcams, images,
                                 *mesh, seed=4)
    assert got[0].shape == want[0].shape
    n = {"colmap": 300, "ray_mesh": 300, "hybrid": 600}[strategy]
    assert len(got[0]) == n
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert np.array_equal(got[1], want[1])


def test_build_init_points_refuses_bad_input(views):
    cams, _, images = views
    with pytest.raises(ValueError, match="unknown init_strategy"):
        IP.build_init_points("sfm", np.zeros((1, 3)), np.zeros((1, 3)),
                             device="cpu")
    with pytest.raises(ValueError, match="requires a scene mesh"):
        IP.build_init_points("hybrid", np.zeros((1, 3)), np.zeros((1, 3)),
                             cams, images, device="cpu")
