"""Shared inputs of the SuGaR parity tests (``test_torch_sugar_*.py``).

The scene is ``tests/test_sugar.py``'s 600-splat sphere shell (radius
1, isotropic scale 0.06, opacity logit 3), made here with numpy so that
both packages get the same arrays without JAX's eager construction;
``uneven`` also perturbs its scales, opacities and rotations.  The JAX
package renders through ``RasterConfig(backend="ref")`` under
``jax.jit`` (eager, its reference path compiles op by op).
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.core.gaussians import Gaussians as JGaussians
from autovfx_tpu.ops.rasterize import RasterConfig as JConfig
from autovfx_tpu.ops.rasterize import rasterize as j_rasterize
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.ops.rasterize import RasterConfig

BUDGET = 1 << 14
JCFG = JConfig(dup_budget=BUDGET, backend="ref")
PCFG = RasterConfig(dup_budget=BUDGET)
VALUE_RTOL = 1e-5  # values, relative to the largest magnitude
GRAD_TOL = 5e-4  # gradients and trained fields, of the largest magnitude


def shell_arrays(n: int = 600, seed: int = 0, uneven: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    xyz = d / np.linalg.norm(d, axis=1, keepdims=True)
    quats = rng.standard_normal((n, 4))
    log_scales = np.full((n, 3), np.log(0.06))
    logit = np.full(n, 3.0)
    if uneven:
        log_scales = log_scales + 0.3 * rng.standard_normal((n, 3))
        logit = 1.5 * rng.standard_normal(n)
    else:
        quats = np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(xyz=f32(xyz), sh_dc=f32(rng.standard_normal((n, 3))),
                sh_rest=f32(0.05 * rng.standard_normal((n, 15, 3))),
                log_scales=f32(log_scales), quats=f32(quats),
                opacity_logit=f32(logit), active=np.ones(n, bool))


def jax_gaussians(a: dict) -> JGaussians:
    return JGaussians(**{k: jnp.asarray(v) for k, v in a.items()})


def port_gaussians(a, device="cpu"):
    if not isinstance(a, dict):
        a = {f: np.asarray(getattr(a, f)) for f in convert.GAUSSIAN_FIELDS}
    return convert.gaussians(a, device=device)


def ring(n: int = 4, width: int = 64, height: int = 48, radius: float = 3.0,
         fx: float = 60.0):
    """JAX cameras around the shell, looking at its centre."""
    return [JC.look_at_camera([radius * np.cos(a), radius * np.sin(a),
                               0.8 * np.sin(2 * a) + 0.3], [0, 0, 0],
                              [0, 0, 1], fx=fx, fy=fx, width=width,
                              height=height)
            for a in np.linspace(0, 2 * np.pi, n, endpoint=False)]


def port_camera(cam, device="cpu"):
    return convert.camera({f: (getattr(cam, f) if f in ("width", "height")
                               else np.asarray(getattr(cam, f)))
                           for f in convert.CAMERA_FIELDS}, device=device)


_render = jax.jit(lambda g, cam: j_rasterize(g, cam, config=JCFG))


def jax_render(g, cam):
    return _render(g, cam)


def jax_draws(g, key, n: int, mask=None):
    """The (idx, eps) that JAX's ``sample_points_in_gaussians`` draws
    from ``key``, as tensors."""
    k1, k2 = jax.random.split(key)
    w = g.active.astype(jnp.float32)
    if mask is not None:
        w = w * mask.astype(jnp.float32)
    idx = jax.random.categorical(k1, jnp.log(jnp.maximum(w, 1e-12)),
                                 shape=(n,))
    return (torch.as_tensor(np.array(idx), dtype=torch.int64),
            torch.as_tensor(np.array(jax.random.normal(k2, (n, 3)))))


def close(got, want, rtol: float = VALUE_RTOL, what: str = "") -> float:
    """Assert max |got − want| ≤ rtol · max |want|; returns the ratio."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(
        got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.3g} of the largest |value|"
    return err


def nearest_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For each row of ``a`` the distance to the nearest row of ``b``."""
    from scipy.spatial import cKDTree

    return cKDTree(np.asarray(b, np.float64)).query(
        np.asarray(a, np.float64))[0]
