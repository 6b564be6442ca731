"""Frame compositor: the shadow ratio and the object pass over the
background, with the semantics of the reference's ``blend_all.py``.

Counterpart of ``autovfx_tpu/render/composite.py``: the shadow ratio
darkens the background by the catcher-alpha weighting, then the object
pass goes over it where a naive depth check puts it in front; optional
3DGS-object occlusion, smoke (alpha max) and additive fire passes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def depth_check(depth1, depth2, d_tol: float = 0.1, option: str = "naive"):
    """Is ``depth1`` in front of ``depth2``?"""
    if option == "naive":
        return depth1 <= depth2
    if option == "tolerance":
        return torch.abs(depth1 - depth2) < d_tol
    if option == "naive_or_tolerance":
        return (depth1 <= depth2) | (torch.abs(depth1 - depth2) < d_tol)
    raise ValueError(option)


class CompositeInputs(NamedTuple):
    bg_color: torch.Tensor  # (H, W, 3) splat background render
    scene_depth: torch.Tensor  # (H, W) shadow-catcher depth
    obj_color: torch.Tensor  # (H, W, 3) inserted-object pass
    obj_alpha: torch.Tensor  # (H, W)
    obj_depth: torch.Tensor  # (H, W)
    shadow_ratio: torch.Tensor  # (H, W) 1 = lit
    catcher_alpha: torch.Tensor  # (H, W) shadow-catcher coverage
    obj3dgs_alpha: Optional[torch.Tensor] = None  # 3DGS-object occlusion
    obj3dgs_depth: Optional[torch.Tensor] = None
    smoke_color: Optional[torch.Tensor] = None
    smoke_alpha: Optional[torch.Tensor] = None
    smoke_depth: Optional[torch.Tensor] = None
    fire_premult: Optional[torch.Tensor] = None  # additive, premultiplied


def composite_frame(inp: CompositeInputs) -> torch.Tensor:
    """One edited frame, clipped to [0, 1]."""
    frame = inp.bg_color
    zero = torch.zeros_like(inp.obj_alpha)

    obj_alpha = inp.obj_alpha
    front = depth_check(inp.obj_depth, inp.scene_depth)

    smoke_front = None
    if inp.smoke_alpha is not None:
        smoke_front = depth_check(inp.smoke_depth, inp.scene_depth)
        obj_alpha = torch.maximum(obj_alpha, inp.smoke_alpha)
        front = front | smoke_front

    obj_mask = obj_alpha > 0.0
    obj_alpha = torch.where(obj_mask & front, obj_alpha, zero)
    non_object_alpha = 1.0 - obj_alpha

    # 3DGS-object pixels keep the background; they also occlude inserted
    # objects where they are in front
    non_3dgs = None
    if inp.obj3dgs_alpha is not None:
        non_3dgs = 1.0 - inp.obj3dgs_alpha
        behind_catcher = depth_check(inp.scene_depth, inp.obj3dgs_depth)
        non_3dgs = torch.where(behind_catcher, torch.ones_like(non_3dgs),
                               non_3dgs)
        gs_front = depth_check(inp.obj3dgs_depth, inp.obj_depth)
        obj_alpha = torch.where(gs_front, obj_alpha * non_3dgs, obj_alpha)

    # step 1: shadow, the catcher-alpha-weighted darkening
    catcher_alpha = non_object_alpha * inp.catcher_alpha
    if non_3dgs is not None:
        catcher_alpha = catcher_alpha * non_3dgs
    ratio = torch.clamp(inp.shadow_ratio, 0.0, 1.0)[..., None]
    shadowed = frame * ratio * catcher_alpha[..., None] + frame * (
        1.0 - catcher_alpha[..., None])
    is_shadow = torch.abs(ratio - 1.0) >= 0.01
    frame = torch.where(is_shadow, shadowed, frame)

    # step 2: objects over the background
    frame_tmp = frame
    blend_mask = (obj_mask & front)[..., None]
    over = inp.obj_color * obj_alpha[..., None] + frame_tmp * (
        1.0 - obj_alpha[..., None])
    frame = torch.where(blend_mask, over, frame)

    if inp.fire_premult is not None and smoke_front is not None:
        fire = inp.fire_premult + frame_tmp * (1.0 - inp.smoke_alpha[..., None])
        frame = torch.where(smoke_front[..., None], fire, frame)

    return torch.clamp(frame, 0.0, 1.0)


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x box downsample of (H, W) or (H, W, C) (an odd last row or
    column is dropped)."""
    h2 = (img.shape[0] // 2) * 2
    w2 = (img.shape[1] // 2) * 2
    x = img[:h2, :w2]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2]
                   + x[1::2, 1::2])


def downsample2x_nearest(img: torch.Tensor) -> torch.Tensor:
    """Nearest 2x downsample, for depth maps."""
    return img[0::2, 0::2]
