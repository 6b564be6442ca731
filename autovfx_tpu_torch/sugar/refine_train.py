"""Refined-SuGaR training: Adam over the mesh-bound Gaussians against views.

Counterpart of ``autovfx_tpu/sugar/refine_train.py`` (itself
``sugar_trainers/refine.py:81-940``): the 3DGS photometric loss (0.8 L1
+ 0.2 D-SSIM), the mesh's normal consistency (pytorch3d
``mesh_normal_consistency``) and an optional uniform Laplacian, with one
Adam a field at the reference's learning rates (:61-68), the vertices'
decaying exponentially from 10·bbox_radius/√V times the initial rate.

A step realizes the bound Gaussians, renders them (kernels 1-3, and
kernel 4 and the preprocess backward in its backward on the card) and
updates in place.  The Adam is this module's own and matches optax's
``adam(eps=1e-15)`` under ``multi_transform``: the moments' bias
corrections at the incremented count, the learning-rate schedule read
at the count before it, ``exponential_decay``'s ``end_value`` as its
floor.  Cameras are drawn from a ``torch.Generator`` or given in order.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from autovfx_tpu_torch.core.cameras import Camera, index_camera
from autovfx_tpu_torch.ops.rasterize import RasterConfig, rasterize
from autovfx_tpu_torch.sugar.refine import PARAM_KEYS, BoundGaussians, realize
from autovfx_tpu_torch.train import losses as L

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    iterations: int = 2_000
    raster: RasterConfig = RasterConfig()
    lambda_dssim: float = 0.2
    normal_consistency: float = 0.1
    laplacian: float = 0.0
    # the reference's learning rates (refine.py:61-68)
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001


class MeshAdjacency(NamedTuple):
    """Index arrays of the mesh regularizers."""

    face_pairs: np.ndarray  # (E2, 2) faces that share an edge
    edge_src: np.ndarray  # (2E,) vertex i of each directed edge
    edge_dst: np.ndarray  # (2E,) vertex j
    degree: np.ndarray  # (V,) vertex degree


def mesh_adjacency(faces: np.ndarray, num_vertices: int) -> MeshAdjacency:
    """Adjacent-face pairs and vertex neighbour edges (host numpy)."""
    faces = np.asarray(faces)
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]], axis=0)
    fidx = np.tile(np.arange(len(faces)), 3)
    key = np.sort(edges, axis=1)
    order = np.lexsort((key[:, 1], key[:, 0]))
    key_s, fidx_s = key[order], fidx[order]
    same = (key_s[1:] == key_s[:-1]).all(axis=1)
    face_pairs = np.stack([fidx_s[:-1][same], fidx_s[1:][same]], axis=1)

    und = np.unique(key, axis=0)
    src = np.concatenate([und[:, 0], und[:, 1]])
    dst = np.concatenate([und[:, 1], und[:, 0]])
    degree = np.bincount(src, minlength=num_vertices)
    return MeshAdjacency(face_pairs=face_pairs.astype(np.int32),
                         edge_src=src.astype(np.int32),
                         edge_dst=dst.astype(np.int32),
                         degree=np.maximum(degree, 1).astype(np.float32))


def face_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    tri = vertices[faces]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                           dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-12)


def normal_consistency_loss(vertices: torch.Tensor, faces: torch.Tensor,
                            pairs: torch.Tensor) -> torch.Tensor:
    """mean(1 − cos) over the normals of adjacent faces."""
    n = face_normals(vertices, faces)
    return torch.mean(1.0 - torch.sum(n[pairs[:, 0]] * n[pairs[:, 1]], dim=-1))


def laplacian_loss(vertices: torch.Tensor, edge_src: torch.Tensor,
                   edge_dst: torch.Tensor, degree: torch.Tensor
                   ) -> torch.Tensor:
    """Uniform Laplacian: mean ‖mean(neighbours) − v‖."""
    nb_sum = torch.zeros_like(vertices).index_add(0, edge_src,
                                                  vertices[edge_dst])
    lap = nb_sum / degree[:, None] - vertices
    return torch.mean(torch.linalg.norm(lap, dim=-1))


def spatial_lr_scale(vertices: torch.Tensor) -> float:
    """10 · bbox radius / √V (refine.py:464-476)."""
    v = vertices.detach().cpu().numpy()
    radius = 0.5 * float(np.linalg.norm(v.max(0) - v.min(0)))
    return 10.0 * radius / max(v.shape[0], 1) ** 0.5


def learning_rates(count: int, cfg: RefineConfig, scale: float) -> dict:
    """Each field's rate at Adam count ``count`` (before its increment),
    in float32 as optax computes it; the vertices' is
    ``exponential_decay`` floored at its end value."""
    f32 = np.float32
    init = f32(cfg.position_lr_init * scale)
    rate = f32(cfg.position_lr_final / cfg.position_lr_init)
    end = f32(cfg.position_lr_final * scale)
    pos = init if count <= 0 else max(
        init * rate ** (f32(count) / f32(cfg.position_lr_max_steps)), end)
    return {"vertices": float(f32(pos)), "log_scales2d": cfg.scaling_lr,
            "rot_complex": cfg.rotation_lr, "vertex_colors": cfg.feature_lr,
            "opacity_logit": cfg.opacity_lr}


@dataclasses.dataclass
class AdamState:
    m: dict
    v: dict
    count: int = 0

    @classmethod
    def zero(cls, params: dict) -> "AdamState":
        return cls(m={k: torch.zeros_like(p) for k, p in params.items()},
                   v={k: torch.zeros_like(p) for k, p in params.items()})


@torch.no_grad()
def adam_update(params: dict, grads: dict, state: AdamState,
                cfg: RefineConfig, scale: float) -> None:
    """One Adam step of every field, in place on ``params`` and ``state``."""
    lrs = learning_rates(state.count, cfg, scale)
    state.count += 1
    f32 = np.float32
    bc1 = float(f32(1) - f32(ADAM_B1) ** f32(state.count))
    bc2 = float(f32(1) - f32(ADAM_B2) ** f32(state.count))
    for k, p in params.items():
        g, m, v = grads[k], state.m[k], state.v[k]
        m.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
        v.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
        p.sub_(lrs[k] * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)))


def refine_step(bg: BoundGaussians, params: dict, adam: AdamState,
                cam: Camera, image: torch.Tensor, cfg: RefineConfig,
                pairs: torch.Tensor, adj: tuple, scale: float):
    """One step: realize, render, the losses, their backward and Adam
    (in place).  Returns (loss, psnr) tensors."""
    with torch.enable_grad():
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        g = realize(bg.replace(**leaves))
        out = rasterize(g, cam, config=cfg.raster)
        loss = L.photometric_loss(out.color, image, cfg.lambda_dssim)
        if cfg.normal_consistency:
            loss = loss + cfg.normal_consistency * normal_consistency_loss(
                leaves["vertices"], bg.faces, pairs)
        if cfg.laplacian:
            loss = loss + cfg.laplacian * laplacian_loss(leaves["vertices"],
                                                         *adj)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    adam_update(params, dict(zip(leaves, grads)), adam, cfg, scale)
    return loss.detach(), L.psnr(out.color.detach(), image)


def refine_train(
    bg: BoundGaussians,
    cams: Camera,
    images: torch.Tensor,
    cfg: RefineConfig = RefineConfig(),
    generator: Optional[torch.Generator] = None,
    log_every: int = 0,
    cam_indices: Optional[Sequence[int]] = None,
):
    """The host loop over ``cfg.iterations`` refine steps; cameras are
    drawn from ``generator`` (a CPU generator with seed 0 by default) or
    given by ``cam_indices``.  Returns (refined bg, history)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dev = bg.vertices.device
    adj = mesh_adjacency(bg.faces.cpu().numpy(), bg.vertices.shape[0])
    pairs = torch.as_tensor(adj.face_pairs, device=dev).to(torch.int64)
    adj_t = (torch.as_tensor(adj.edge_src, device=dev).to(torch.int64),
             torch.as_tensor(adj.edge_dst, device=dev).to(torch.int64),
             torch.as_tensor(adj.degree, device=dev))
    scale = spatial_lr_scale(bg.vertices)
    params = {k: getattr(bg, k).detach().clone() for k in PARAM_KEYS}
    adam = AdamState.zero(params)
    n_cams = images.shape[0]
    history = []
    for it in range(1, cfg.iterations + 1):
        ci = (int(torch.randint(n_cams, (), generator=generator,
                                device=generator.device))
              if cam_indices is None else int(cam_indices[it - 1]))
        loss, psnr = refine_step(bg, params, adam, index_camera(cams, ci),
                                 images[ci], cfg, pairs, adj_t, scale)
        if log_every and it % log_every == 0:
            history.append({"iter": it, "loss": float(loss),
                            "psnr": float(psnr)})
    return bg.replace(**params), history
