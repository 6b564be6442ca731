"""The least time a kernel's work can take on one H100, counted from its
inputs and shapes: the yardstick of every roofline and mfu share.

Frozen copies of ``chip_smoke.py``'s ``bound`` and ``*_work`` counters,
against published peaks only: HBM3 at 3.35 TB/s, 67 TFLOP/s float32
outside the tensor cores, and the special-function units' exp at 16 a
clock on each of 132 SMs at the 1,980 MHz boost clock (NVIDIA H100
whitepaper and data sheet, SXM5, 700 W).  A kernel's bound is the
larger of its bytes (each input read once, each output written once)
over the memory rate and its operations over their rate.  The blend
counts come from the benchmark's plain blend (``reference.raster``),
never from the program's own counters, so a kernel that culls more
cannot move its yardstick.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SMS, SFU_PER_SM_CLOCK, BOOST_HZ = 132, 16, 1.98e9
EXP_PER_S = SMS * SFU_PER_SM_CLOCK * BOOST_HZ
# float32 operations (an FMA is 2) per blended (pixel, duplicate) pair:
# the forward's alpha, T, weight, color and depth; the backward's alpha,
# 1 - alpha, f, T, dL/dalpha, S, dL/dpower and the ten gradient terms
BLEND_FLOPS, BLEND_BWD_FLOPS = 12, 50
# a lower count of the per-splat arithmetic of the preprocess and its
# backward, far below their byte time either way
PREPROCESS_FLOPS, PREPROCESS_BWD_FLOPS = 200, 400
CAMERA_BYTES = 84


def bound_s(work: tuple) -> float:
    """Seconds at the peak for ``(bytes, f32 operations, exp operations)``."""
    n_bytes, flops, sfu = work
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S,
               sfu / EXP_PER_S)


def params_per_splat(k_rest: int) -> int:
    """Floats of one splat's trained fields: xyz, SH DC and rest,
    log-scales, quaternion, opacity logit."""
    return 3 + 3 + 3 * k_rest + 3 + 4 + 1


def preprocess(n: int, k_rest: int) -> tuple:
    """Kernel 1 over ``n`` slots: reads the fields and the active flag,
    writes mean2d, conic, opacity, color, depth, radius, tile rect and
    tile count."""
    read = 4 * params_per_splat(k_rest) + 1
    write = 4 * (2 + 3 + 1 + 3 + 1 + 1 + 2 + 2 + 1)
    return n * (read + write) + CAMERA_BYTES, n * PREPROCESS_FLOPS, 0.0


def duplicate(n: int, n_live: int, budget: int) -> tuple:
    """Kernel 2: every slot's tile count; a live slot's offset, rect and
    depth; an int64 key and int32 gid for every slot of the budget."""
    return 4 * n + (8 + 8 + 8 + 4) * n_live + 12 * budget, 0.0, 0.0


def preprocess_bwd(n: int, k_rest: int) -> tuple:
    """The preprocess backward: a slot reads its fields, its tile count
    and 10 output gradients and writes one gradient per field."""
    p = params_per_splat(k_rest)
    return (n * 4 * (p + 1 + 10 + p) + CAMERA_BYTES,
            n * PREPROCESS_BWD_FLOPS, 0.0)


def blend(c, backward: bool = False, train: bool = False) -> tuple:
    """Kernel 3 (``train``: its training variant) or kernel 4 over a view
    whose plain-blend counts are ``c`` (``reference.raster.Counts``):
    each tile's range, the gid of every duplicate up to the tile's last
    blended one, each live splat's 10 features (and, backward, its 10
    gradients), the images per pixel; the blend and exp of each blended
    pair (backward: and a reciprocal)."""
    per_pixel = 28 if backward or train else 20
    n_bytes = (8 * c.tiles + 4 * c.dups_reached
               + 40 * c.live * (2 if backward else 1) + per_pixel * c.pixels)
    flops = (BLEND_BWD_FLOPS if backward else BLEND_FLOPS) * c.blended
    return n_bytes, flops, (2 if backward else 1) * c.blended


def adam(n: int, k_rest: int) -> tuple:
    """Adam over ``n`` slots: each parameter, gradient and both moments
    read once; each parameter and moment written once; the active flag
    read once."""
    p = params_per_splat(k_rest)
    return n * (4 * p * 7 + 1), 0.0, 0.0
