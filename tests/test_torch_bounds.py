"""The bound arithmetic of ``chip_smoke.py`` against hand counts.

A kernel's bound is the least time the card could take for its work:
the larger of the bytes it must move over the memory rate and its
operations over the peak rate of their kind.  These tests pin the byte
and operation counts of each kernel to counts made by hand, and the
(pixel, duplicate) pair counts of the blends to a per-pixel loop that
blends as the kernels do.  CPU only.
"""
import numpy as np
import pytest
import torch

import autovfx_tpu_torch as P
import chip_smoke as cs
from autovfx_tpu_torch.core.cameras import look_at_camera
from autovfx_tpu_torch.ops import binning, projection
from autovfx_tpu_torch.utils.synthetic import make_garden_like


def test_bound_takes_the_slowest_rate():
    assert cs.bound(3.35e9) == {"bound_ms": pytest.approx(1.0),
                                "bound_by": "bytes", "bound_rate": "memory"}
    b = cs.bound(1.0, flops=67e9)
    assert b["bound_by"] == "operations" and b["bound_rate"] == "f32"
    assert b["bound_ms"] == pytest.approx(1.0)
    exps = 132 * 16 * 1980e6 * 1e-3  # one millisecond of exp at 1980 MHz
    b = cs.bound(1.0, flops=1.0, sfu_ops=exps, sm_clock_mhz=1980.0)
    assert b["bound_rate"] == "exp" and b["bound_ms"] == pytest.approx(1.0)
    # at half the clock the same exps take twice as long
    assert cs.bound(0.0, sfu_ops=exps, sm_clock_mhz=990.0)["bound_ms"] == \
        pytest.approx(2.0)


@pytest.mark.parametrize("k_rest, per_slot", [
    # parameters: xyz 3, sh_dc 3, sh_rest 3k, log-scales 3, quats 4, logit
    # 1; read with the tile count and 10 output gradients, written once
    (15, (59 + 1 + 10 + 59) * 4),  # 280 B read, 236 written: 516
    (3, (23 + 1 + 10 + 23) * 4),
    (0, (14 + 1 + 10 + 14) * 4),
])
def test_preprocess_bwd_bytes(k_rest, per_slot):
    n = 1000
    n_bytes, flops, sfu = cs.preprocess_bwd_work(n, k_rest)
    assert n_bytes == n * per_slot + 84  # the camera's 21 floats once
    assert cs.preprocess_bwd_work(1, 15)[0] - 84 == 516
    assert flops == n * cs.PREPROCESS_BWD_FLOPS and sfu == 0


def test_preprocess_bytes():
    # 56 B of parameters + 12 per SH rest coefficient + the active byte
    # read; mean2d 8, conic 12, opacity 4, color 12, depth 4, radius 4,
    # tile rect 16, tiles touched 4 written
    assert cs.preprocess_work(1, 15)[0] == (56 + 180 + 1) + 64 + 84
    assert cs.preprocess_work(1_000_000, 15)[0] == 301_000_084


def test_duplicate_bytes():
    # every slot's tile count (4), a live slot's int64 offset, int32 rect
    # and f32 depth (28), and an int64 key and int32 gid for every slot
    # of the budget: the kernel writes the sentinel slots too
    n, n_live, budget = 10, 4, 7
    assert cs.duplicate_work(n, n_live, budget) == (
        40 + 4 * 28 + 7 * 12, 0.0, 0.0)
    assert cs.duplicate_work(n, n_live, 4096)[0] == 40 + 4 * 28 + 4096 * 12


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112blend_kernelILi2ELb1EEEvPKiS2_PKfS4_S4_S4_S4_iiiiPfS5_S5_S5_Pi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112blend_kernelILi2ELb1EEEvPKiS2_PKfS4_S4_S4_S4_iiiiPfS5_S5_S5_Pi
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 11264 bytes smem, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116duplicate_kernelEiPKiPKlS1_S1_PKfiilPlPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116duplicate_kernelEiPKiPKlS1_S1_PKfiilPlPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 1 barriers, 5120 bytes smem, 440 bytes cmem[0]
"""


def test_ptxas_report_and_blocks_per_sm():
    assert cs.ptxas_kernels(PTXAS_LOG) == [
        ("blend_kernel<2,1>", 80, 11264, 8), ("duplicate_kernel", 26, 5120, 0)]
    # registers go 256 to a warp: 80 a thread is 2560 a warp, 25 warps of
    # 65,536, 3 blocks of 8; 64 a thread fits 4, 65 only 3
    assert cs.blocks_per_sm(80, 11264, 256) == 3
    assert cs.blocks_per_sm(64, 0, 256) == 4
    assert cs.blocks_per_sm(65, 0, 256) == 3
    # 2048 threads an SM, and shared memory: 35,840 B a block plus 1 KB
    assert cs.blocks_per_sm(26, 5120, 256) == 8
    assert cs.blocks_per_sm(32, 35840, 128) == 6


def test_contrib_counts_of_two_tiles():
    # an 8 x 4 image of two 4 x 4 tiles
    n_contrib = torch.zeros((4, 8), dtype=torch.int32)
    n_contrib[:, :4] = 3
    n_contrib[1, 2] = 7
    n_contrib[3, 5] = 2
    c = cs.contrib_counts(n_contrib, 4)
    assert c == {"pixels": 32, "tiles": 2, "pairs": 15 * 3 + 7 + 2,
                 "dups_reached": 7 + 2, "tile_pairs_max": 15 * 3 + 7}
    # a ragged edge: a fifth row makes a second row of tiles
    ragged = torch.cat([n_contrib, torch.full((1, 8), 5, dtype=torch.int32)])
    c = cs.contrib_counts(ragged, 4)
    assert (c["tiles"], c["pairs"], c["dups_reached"]) == (4, 54 + 40, 9 + 10)
    assert c["tile_pairs_max"] == 52


def test_blend_work_counts():
    counts = {"pixels": 100, "tiles": 2, "pairs": 1000, "dups_reached": 50,
              "blended": 10}
    # tile ranges 8 B, gids 4 B, features 40 B per live splat, and per
    # pixel 20 B of images (28 with T and n_contrib)
    # operations: only the blended pairs, whatever the pairs reached
    assert cs.blend_work(counts, 20) == (16 + 200 + 800 + 2000, 12 * 10, 10)
    assert cs.blend_work({**counts, "pairs": 10}, 20)[1:] == (12 * 10, 10)
    assert cs.blend_work(counts, 20, train=True)[0] == 16 + 200 + 800 + 2800
    # kernel 4 also writes 40 B of gradients per live splat, reads 28 B a
    # pixel, and takes an exp and a reciprocal per blended pair
    assert cs.blend_work(counts, 20, backward=True) == (
        16 + 200 + 1600 + 2800, 50 * 10, 20)


def _sequential_blend(binned, s, width, height, tile):
    """Per pixel, as the kernels blend: (n_contrib, blended pairs)."""
    f32 = np.float32
    tx = binned.num_tiles_x
    n_contrib = np.zeros((height, width), np.int32)
    blended = 0
    xy, co = s.mean2d.numpy(), s.conic.numpy()
    op, gid = s.opacity.numpy(), binned.gid.numpy()
    for t, (lo, hi) in enumerate(binned.tile_range.numpy()):
        ys, xs = np.mgrid[(t // tx) * tile:(t // tx + 1) * tile,
                          (t % tx) * tile:(t % tx + 1) * tile]
        inside = (xs < width) & (ys < height)
        px, py = xs.astype(f32), ys.astype(f32)
        T = np.ones(px.shape, f32)
        done = ~inside
        last = np.zeros(px.shape, np.int32)
        for k in range(lo, hi):
            g = gid[k]
            dx, dy = xy[g, 0] - px, xy[g, 1] - py
            power = (f32(-0.5) * (co[g, 0] * dx * dx + co[g, 2] * dy * dy)
                     - co[g, 1] * dx * dy)
            alpha = np.minimum(f32(0.99), op[g] * np.exp(power))
            ok = ~done & (power <= 0) & (alpha >= f32(1.0 / 255.0))
            test_t = T * (f32(1.0) - alpha)
            done |= ok & (test_t < f32(1e-4))
            ok &= ~(test_t < f32(1e-4))
            T = np.where(ok, test_t, T)
            last = np.where(ok, k - lo + 1, last)
            blended += int(ok.sum())
        n_contrib[ys[inside], xs[inside]] = last[inside]
    return torch.from_numpy(n_contrib), blended


@pytest.mark.parametrize("tile", [16, 32])
def test_pair_counts_match_a_per_pixel_blend(tile):
    width, height = 72, 40  # ragged tiles at both edges
    g = make_garden_like(3000, seed=5, extent=2.67, device="cpu")
    cam = look_at_camera([2.6, 0.3, 1.4], [0, 0, 0.2], [0, 0, 1], fx=50.0,
                         fy=50.0, width=width, height=height, device="cpu")
    s = projection.preprocess(g, cam, tile=tile)
    b = binning.bin_splats(s, width, height, 1 << 16, tile=tile)
    n_contrib, blended = _sequential_blend(b, s, width, height, tile)
    assert blended > 1000
    counts = cs.pair_counts(P, b, s, n_contrib, width, height, tile)
    assert counts["pairs"] == int(n_contrib.sum())
    # the plain blend decides the freeze in float64, the loop in float32
    assert abs(counts["blended"] - blended) <= max(2, 1e-3 * blended)
