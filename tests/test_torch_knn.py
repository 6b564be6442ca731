"""Morton-window k-nearest neighbours of the PyTorch port vs the JAX
package, on the CPU.

The same points (numpy, seeded) go through both packages' ``knn``.
Morton codes must be equal; ``mean_knn_dist2`` and ``knn_indices`` must
give the same values (rtol 1e-6 on squared distances, which both sum in
float32 in the same order) and the same neighbour indices.  Equal
distances keep the order of the stable Morton argsort in both.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.ops import knn as JK
from autovfx_tpu_torch.ops import knn as K


def points(n, seed, with_mask):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((n, 3)) * [1.0, 0.5, 2.0]).astype(np.float32)
    xyz[:5] = xyz[5]  # a few exact duplicates: ties at distance 0
    mask = rng.random(n) > 0.2 if with_mask else None
    return xyz, mask


def both(fn_j, fn_p, xyz, mask, **kw):
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else torch.from_numpy(mask)
    return fn_j(jnp.asarray(xyz), jm, **kw), fn_p(torch.from_numpy(xyz), pm,
                                                  **kw)


@pytest.mark.parametrize("with_mask", [False, True])
def test_morton_codes_match_jax(with_mask):
    xyz, mask = points(300, 0, with_mask)
    want, got = both(JK.morton_codes, K.morton_codes, xyz, mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("k,window", [(3, 32), (3, 8)])
def test_mean_knn_dist2_matches_jax(with_mask, k, window):
    xyz, mask = points(400, 1, with_mask)
    want, got = both(JK.mean_knn_dist2, K.mean_knn_dist2, xyz, mask, k=k,
                     window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-12)
    if mask is not None:
        assert float(got[torch.from_numpy(~mask)].abs().max()) == 0.0


@pytest.mark.parametrize("with_mask", [False, True])
def test_knn_indices_match_jax(with_mask):
    xyz, mask = points(300, 2, with_mask)
    (j_idx, j_d2), (idx, d2) = both(JK.knn_indices, K.knn_indices, xyz, mask,
                                    k=16, window=48)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(j_d2), rtol=1e-6,
                               atol=1e-12)
    assert (idx[:, 0] == torch.arange(300)).float().mean() > 0.9  # self first


def test_init_scales_match_jax():
    from autovfx_tpu.train.trainer import init_gaussians_from_points as j_init
    from autovfx_tpu_torch.train.trainer import init_gaussians_from_points

    xyz, _ = points(200, 3, False)
    rgb = np.random.default_rng(3).random((200, 3), np.float32)
    want = j_init(jnp.asarray(xyz), jnp.asarray(rgb))
    got = init_gaussians_from_points(torch.from_numpy(xyz),
                                     torch.from_numpy(rgb))
    for f in ("log_scales", "sh_dc", "opacity_logit", "quats"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
