"""Kernel 1 wrapper: the fused per-splat preprocess (``csrc/preprocess.cu``).

A CUDA tensor goes through the kernel, or the call raises; a CPU tensor
goes through the plain version ``projection.preprocess``.  ``launches``
counts kernel launches and nothing else.
"""
from __future__ import annotations

from typing import Optional

import torch

from autovfx_tpu_torch.core.cameras import Camera
from autovfx_tpu_torch.core.gaussians import Gaussians
from autovfx_tpu_torch.ops import _build, projection
from autovfx_tpu_torch.ops._build import check_tensor
from autovfx_tpu_torch.ops.projection import Splats2D

launches = 0


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
) -> Splats2D:
    """Project all Gaussians to screen space (see ``projection.preprocess``)."""
    if not g.xyz.is_cuda:
        return projection.preprocess(
            g, cam, scaling_modifier=scaling_modifier,
            override_color=override_color, sh_degree=sh_degree, tile=tile,
        )
    return preprocess_kernel(g, cam, scaling_modifier, override_color,
                             sh_degree, tile)


def preprocess_kernel(
    g: Gaussians,
    cam: Camera,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    tile: int = projection.TILE,
) -> Splats2D:
    global launches
    n = g.capacity
    k_rest = g.sh_rest.shape[1]
    degree = min(g.sh_degree if sh_degree is None else sh_degree, 3)
    if degree > g.sh_degree:
        raise ValueError(f"sh_degree {degree} exceeds the stored {g.sh_degree}")
    f32 = torch.float32
    check_tensor(g.xyz, "xyz", f32, (n, 3))
    check_tensor(g.sh_dc, "sh_dc", f32, (n, 3))
    check_tensor(g.sh_rest, "sh_rest", f32, (n, k_rest, 3))
    check_tensor(g.log_scales, "log_scales", f32, (n, 3))
    check_tensor(g.quats, "quats", f32, (n, 4))
    check_tensor(g.opacity_logit, "opacity_logit", f32, (n,))
    check_tensor(g.active, "active", torch.bool, (n,))
    if override_color is not None:
        check_tensor(override_color, "override_color", f32, (n, 3))
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
