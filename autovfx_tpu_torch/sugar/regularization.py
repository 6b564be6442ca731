"""SuGaR's coarse-training regularization terms.

Counterpart of ``autovfx_tpu/sugar/regularization.py`` (itself
``sugar_trainers/coarse_density.py``): the opacity entropy (:593-606),
near-surface samples with neighbour lists (:166, :668-690), the
density-target loss |exp(-d²/2β²) − density| against the rendered-depth
distance estimate (:700-742), its SDF form (``coarse_sdf.py``) and the
field-normal consistency with the samples' source Gaussians (:753-779).

The distance estimate reads the rendered depth and alpha at the
samples' pixels, so its gradient reaches the blend backward (kernel 4
on the card) as depth and alpha cotangents.

The density and normal terms read the field at the same samples: each
takes the evaluated ``field`` (``density.density_field``'s density and
gradient), so that a step that runs both evaluates it once; without
it, a term evaluates what it reads itself.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from autovfx_tpu_torch.core.cameras import Camera
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.sugar import density as D
from autovfx_tpu_torch.utils.gather import take

Field = tuple[torch.Tensor, torch.Tensor]  # density (S,), gradient (S, 3)


def opacity_entropy_loss(g: Gaussians) -> torch.Tensor:
    """-mean[o ln o + (1-o) ln(1-o)] over the active slots, pushing the
    opacities to 0 or 1."""
    o = torch.clamp(g.opacity, 1e-6, 1 - 1e-6)
    ent = -(o * torch.log(o) + (1 - o) * torch.log(1 - o))
    w = g.active.to(torch.float32)
    return torch.sum(ent * w) / torch.clamp(w.sum(), min=1.0)


class SdfSamples(NamedTuple):
    points: torch.Tensor  # (S, 3)
    source: torch.Tensor  # (S,) the Gaussian each was sampled from
    neighbors: torch.Tensor  # (S, k) Gaussian neighbour lists


def sample_sdf_points(
    g: Gaussians,
    generator: Optional[torch.Generator],
    num_samples: int,
    visibility_mask: Optional[torch.Tensor] = None,
    k: int = 16,
    draws: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> SdfSamples:
    """Samples in the (visible) Gaussians, each with its source
    Gaussian's k-NN list over every slot (``draws`` as in
    ``density.sample_points_in_gaussians``)."""
    pts, src = D.sample_points_in_gaussians(
        g, generator, num_samples, mask=visibility_mask, draws=draws)
    return SdfSamples(points=pts, source=src,
                      neighbors=take(D.reset_neighbors(g, k=k), src))


def estimate_surface_distance(
    samples: torch.Tensor,  # (S, 3)
    cam: Camera,
    depth_map: torch.Tensor,  # (H, W) alpha-weighted depth
    alpha_map: torch.Tensor,  # (H, W)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(|sample depth − rendered surface depth| along the camera ray,
    valid mask), both (S,); the pixel is the sample's projection
    truncated toward zero."""
    uv, z = cam.project(samples)
    x = torch.clamp(uv[:, 0].to(torch.int64), 0, cam.width - 1)
    y = torch.clamp(uv[:, 1].to(torch.int64), 0, cam.height - 1)
    pix = y * cam.width + x
    a = take(alpha_map.reshape(-1), pix)
    surf = take(depth_map.reshape(-1), pix) / torch.clamp(a, min=1e-6)
    valid = ((z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
             & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height) & (a > 0.5))
    return torch.abs(z - surf), valid


def _density(g: Gaussians, samples: SdfSamples,
             field: Optional[Field]) -> torch.Tensor:
    if field is None:
        return D.compute_density(samples.points, samples.neighbors, g)
    return field[0]


def _masked_mean(err: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    w = valid.to(torch.float32)
    return torch.sum(err * w) / torch.clamp(w.sum(), min=1.0)


def density_regularization_loss(
    g: Gaussians,
    samples: SdfSamples,
    cam: Camera,
    depth_map: torch.Tensor,
    alpha_map: torch.Tensor,
    field: Optional[Field] = None,
) -> torch.Tensor:
    """|target − density| with target = exp(-d²/(2β²))."""
    dist, valid = estimate_surface_distance(samples.points, cam, depth_map,
                                            alpha_map)
    beta = torch.clamp(D.compute_beta(samples.points, samples.neighbors, g),
                       min=1e-6)
    target = torch.exp(-(dist**2) / (2.0 * beta**2))
    dens = torch.clamp(_density(g, samples, field), 0.0, 1.0)
    return _masked_mean(torch.abs(target - dens), valid)


def sdf_regularization_loss(
    g: Gaussians,
    samples: SdfSamples,
    cam: Camera,
    depth_map: torch.Tensor,
    alpha_map: torch.Tensor,
    field: Optional[Field] = None,
) -> torch.Tensor:
    """|sdf estimate − d| / β."""
    dist, valid = estimate_surface_distance(samples.points, cam, depth_map,
                                            alpha_map)
    beta = torch.clamp(D.compute_beta(samples.points, samples.neighbors, g),
                       min=1e-6)
    dens = _density(g, samples, field)
    sdf_est = D.density_to_sdf(dens, beta)
    return _masked_mean(torch.abs(sdf_est - dist) / beta, valid)


def normal_consistency_loss(g: Gaussians, samples: SdfSamples,
                            field: Optional[Field] = None) -> torch.Tensor:
    """mean(1 − |cos|) between the field's normal at each sample and its
    source Gaussian's min-axis normal (the first axis where scales tie,
    as the JAX package's argmin takes it)."""
    grad = (D.density_gradient(samples.points, samples.neighbors, g)
            if field is None else field[1])
    n_field = grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True),
                                 min=1e-9)
    n_gauss = take(g.normals(), samples.source)
    return torch.mean(1.0 - torch.abs(torch.sum(n_field * n_gauss, dim=-1)))
