"""Kernel 1 wrapper: the fused per-splat preprocess (``csrc/preprocess.cu``),
and its backward (``csrc/preprocess_bwd.cu``).

A CUDA tensor goes through the kernels, or the call raises; a CPU tensor
goes through the plain versions: ``projection.preprocess`` and, for the
backward, autograd of it (``preprocess_bwd_plain``).  ``PreprocessFn``
joins the two into a ``torch.autograd.Function`` for the training path.
``launches`` and ``bwd_launches`` count kernel launches and nothing
else.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from autovfx_tpu_torch.core.cameras import Camera
from autovfx_tpu_torch.core.gaussians import PARAM_FIELDS, Gaussians
from autovfx_tpu_torch.ops import _build, projection
from autovfx_tpu_torch.ops._build import check_tensor
from autovfx_tpu_torch.ops.blend_ref import SplatGrads
from autovfx_tpu_torch.ops.projection import Splats2D

launches = 0
bwd_launches = 0


class ParamGrads(NamedTuple):
    """Gradients of the Gaussians' parameters (and of an override color)."""

    xyz: torch.Tensor
    sh_dc: torch.Tensor
    sh_rest: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logit: torch.Tensor
    override_color: Optional[torch.Tensor]


def camera_params(cam: Camera) -> torch.Tensor:
    """(21,) f32 device tensor in the layout of ``preprocess.cu``'s
    CAM_* offsets: R (row-major), t, fx, fy, cx, cy, 1.3·tan(fov/2) in x
    and y, camera center.  Built with tensor ops, so no host sync."""
    f = lambda v: v.reshape(1).to(torch.float32)
    return torch.cat([
        cam.R.reshape(9).to(torch.float32), cam.t.reshape(3).to(torch.float32),
        f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy),
        f(1.3 * cam.tan_half_fovx), f(1.3 * cam.tan_half_fovy),
        cam.center.reshape(3).to(torch.float32),
    ])


def preprocess(
    g: Gaussians,
    cam: Camera,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    tile: int = projection.TILE,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> Splats2D:
    """Project all Gaussians to screen space (see ``projection.preprocess``)."""
    if not g.xyz.is_cuda:
        return projection.preprocess(
            g, cam, scaling_modifier=scaling_modifier,
            override_color=override_color, sh_degree=sh_degree, tile=tile,
            mean2d_offset=mean2d_offset,
        )
    return preprocess_kernel(g, cam, scaling_modifier, override_color,
                             sh_degree, tile, mean2d_offset)


def _degree(g: Gaussians, sh_degree: Optional[int]) -> int:
    degree = min(g.sh_degree if sh_degree is None else sh_degree, 3)
    if degree > g.sh_degree:
        raise ValueError(f"sh_degree {degree} exceeds the stored {g.sh_degree}")
    return degree


def _check_gaussians(g: Gaussians) -> None:
    n, f32 = g.capacity, torch.float32
    check_tensor(g.xyz, "xyz", f32, (n, 3))
    check_tensor(g.sh_dc, "sh_dc", f32, (n, 3))
    check_tensor(g.sh_rest, "sh_rest", f32, (n, g.sh_rest.shape[1], 3))
    check_tensor(g.log_scales, "log_scales", f32, (n, 3))
    check_tensor(g.quats, "quats", f32, (n, 4))
    check_tensor(g.opacity_logit, "opacity_logit", f32, (n,))
    check_tensor(g.active, "active", torch.bool, (n,))


def preprocess_kernel(
    g: Gaussians,
    cam: Camera,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    tile: int = projection.TILE,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> Splats2D:
    global launches
    n = g.capacity
    k_rest = g.sh_rest.shape[1]
    degree = _degree(g, sh_degree)
    f32 = torch.float32
    _check_gaussians(g)
    if override_color is not None:
        check_tensor(override_color, "override_color", f32, (n, 3))
    if mean2d_offset is not None:
        check_tensor(mean2d_offset, "mean2d_offset", f32, (n, 2))
    cam_p = camera_params(cam)
    check_tensor(cam_p, "camera params", f32, (21,))

    tiles_x, tiles_y = projection.num_tiles(cam.width, cam.height, tile)
    dev = g.xyz.device
    fe = lambda *s: torch.empty(s, dtype=f32, device=dev)
    ie = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    out = Splats2D(
        mean2d=fe(n, 2), conic=fe(n, 3), color=fe(n, 3), opacity=fe(n),
        depth=fe(n), radius=ie(n), tile_min=ie(n, 2), tile_max=ie(n, 2),
        tiles_touched=ie(n),
    )
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.preprocess_fwd(
            n, g.xyz.data_ptr(), g.sh_dc.data_ptr(), g.sh_rest.data_ptr(),
            k_rest, degree, g.log_scales.data_ptr(), g.quats.data_ptr(),
            g.opacity_logit.data_ptr(), g.active.data_ptr(),
            None if override_color is None else override_color.data_ptr(),
            None if mean2d_offset is None else mean2d_offset.data_ptr(),
            cam_p.data_ptr(), float(scaling_modifier), tile, tiles_x, tiles_y,
            out.mean2d.data_ptr(), out.conic.data_ptr(),
            out.opacity.data_ptr(), out.color.data_ptr(),
            out.depth.data_ptr(), out.radius.data_ptr(),
            out.tile_min.data_ptr(), out.tile_max.data_ptr(),
            out.tiles_touched.data_ptr(), stream,
        )
    _build.check(lib, err, "preprocess_fwd")
    launches += 1
    return out


# ---- backward ------------------------------------------------------------


def preprocess_bwd(
    g: Gaussians,
    cam: Camera,
    tiles_touched: torch.Tensor,
    d: SplatGrads,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    tile: int = projection.TILE,
) -> ParamGrads:
    """Gradients of the parameters from those of the preprocess outputs
    ``d`` (``tiles_touched`` is the forward's: > 0 marks the valid
    slots, where opacity reaches the logit)."""
    fn = preprocess_bwd_kernel if g.xyz.is_cuda else preprocess_bwd_plain
    return fn(g, cam, tiles_touched, d, scaling_modifier, override_color,
              sh_degree, tile)


def preprocess_bwd_plain(
    g: Gaussians,
    cam: Camera,
    tiles_touched: torch.Tensor,
    d: SplatGrads,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    tile: int = projection.TILE,
) -> ParamGrads:
    """Autograd of ``projection.preprocess``, recomputed (it finds the
    valid slots itself, so ``tiles_touched`` is not read)."""
    with torch.enable_grad():
        leaves = {f: getattr(g, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        ov = (None if override_color is None
              else override_color.detach().requires_grad_(True))
        s = projection.preprocess(
            dataclasses.replace(g, **leaves), cam,
            scaling_modifier=scaling_modifier, override_color=ov,
            sh_degree=sh_degree, tile=tile,
        )
        inputs = list(leaves.values()) + ([] if ov is None else [ov])
        grads = torch.autograd.grad(
            (s.mean2d, s.conic, s.opacity, s.color, s.depth), inputs,
            grad_outputs=(d.mean2d, d.conic, d.opacity, d.color, d.depth),
            allow_unused=True,
        )
    grads = [torch.zeros_like(x) if gr is None else gr
             for x, gr in zip(inputs, grads)]
    return ParamGrads(*grads[:6], override_color=grads[6] if ov is not None
                      else None)


def preprocess_bwd_kernel(
    g: Gaussians,
    cam: Camera,
    tiles_touched: torch.Tensor,
    d: SplatGrads,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    tile: int = projection.TILE,
) -> ParamGrads:
    """``csrc/preprocess_bwd.cu``; ``tile`` is not read (the forward's
    ``tiles_touched`` carries the rect)."""
    global bwd_launches
    n = g.capacity
    k_rest = g.sh_rest.shape[1]
    degree = _degree(g, sh_degree)
    f32 = torch.float32
    _check_gaussians(g)
    check_tensor(tiles_touched, "tiles_touched", torch.int32, (n,))
    for name, shape in (("mean2d", (n, 2)), ("conic", (n, 3)),
                        ("opacity", (n,)), ("color", (n, 3)),
                        ("depth", (n,))):
        check_tensor(getattr(d, name), f"d {name}", f32, shape)
    cam_p = camera_params(cam)
    check_tensor(cam_p, "camera params", f32, (21,))
    out = ParamGrads(*(torch.empty_like(getattr(g, f)) for f in PARAM_FIELDS),
                     override_color=None)
    lib = _build.load_library()
    with torch.cuda.device(g.xyz.device):
        err = lib.preprocess_bwd(
            n, g.xyz.data_ptr(), g.sh_dc.data_ptr(), g.sh_rest.data_ptr(),
            k_rest, degree, g.log_scales.data_ptr(), g.quats.data_ptr(),
            g.opacity_logit.data_ptr(), tiles_touched.data_ptr(),
            int(override_color is None), cam_p.data_ptr(),
            float(scaling_modifier), d.mean2d.data_ptr(), d.conic.data_ptr(),
            d.opacity.data_ptr(), d.color.data_ptr(), d.depth.data_ptr(),
            *(x.data_ptr() for x in out[:6]),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "preprocess_bwd")
    bwd_launches += 1
    if override_color is not None:
        out = out._replace(override_color=d.color)
    return out


class PreprocessFn(torch.autograd.Function):
    """Differentiable preprocess: kernel 1 forward, ``preprocess_bwd``
    backward (each dispatched on the device of the tensors).

    ``apply(xyz, sh_dc, sh_rest, log_scales, quats, opacity_logit,
    override_color, mean2d_offset, active, cam, scaling_modifier,
    sh_degree, tile)`` returns the nine ``Splats2D`` fields; the float
    ones are differentiable.  ``override_color`` and ``mean2d_offset`` may
    be None; the gradient of ``mean2d_offset`` is that of ``mean2d``."""

    @staticmethod
    def forward(ctx, xyz, sh_dc, sh_rest, log_scales, quats, opacity_logit,
                override_color, mean2d_offset, active, cam, scaling_modifier,
                sh_degree, tile):
        g = Gaussians(xyz, sh_dc, sh_rest, log_scales, quats, opacity_logit,
                      active)
        s = preprocess(g, cam, scaling_modifier, override_color, sh_degree,
                       tile, mean2d_offset)
        ctx.save_for_backward(xyz, sh_dc, sh_rest, log_scales, quats,
                              opacity_logit, active, override_color,
                              s.tiles_touched)
        ctx.cam, ctx.args = cam, (scaling_modifier, sh_degree, tile)
        ctx.has_offset = mean2d_offset is not None
        ctx.mark_non_differentiable(s.radius, s.tile_min, s.tile_max,
                                    s.tiles_touched)
        return tuple(s)

    @staticmethod
    def backward(ctx, d_mean2d, d_conic, d_color, d_opacity, d_depth, *_):
        *params, active, override_color, tiles_touched = ctx.saved_tensors
        g = Gaussians(*params, active)
        scaling_modifier, sh_degree, tile = ctx.args
        d = SplatGrads(mean2d=d_mean2d.contiguous(),
                       conic=d_conic.contiguous(),
                       opacity=d_opacity.contiguous(),
                       color=d_color.contiguous(),
                       depth=d_depth.contiguous())
        r = preprocess_bwd(g, ctx.cam, tiles_touched, d, scaling_modifier,
                           override_color, sh_degree, tile)
        return (*r[:6], r.override_color,
                d_mean2d if ctx.has_offset else None,
                None, None, None, None, None)


def preprocess_differentiable(
    g: Gaussians,
    cam: Camera,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    tile: int = projection.TILE,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> Splats2D:
    """``preprocess`` through ``PreprocessFn``."""
    return Splats2D(*PreprocessFn.apply(
        *(getattr(g, f) for f in PARAM_FIELDS), override_color,
        mean2d_offset, g.active, cam, scaling_modifier, sh_degree, tile))
