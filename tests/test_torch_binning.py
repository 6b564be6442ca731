"""Binning of the PyTorch port vs the JAX package, on the CPU.

The JAX ``Splats2D`` of the golden scene is carried into the port, so
both binnings see the same splats.  The port's per-tile gid sequence
must equal the JAX one (``pad_mode="chunk"``, with ``fill_backend``
"xla" and the Pallas fill in interpret mode) once JAX's pad entries
(``gid == N``) are removed: exactly, since both orders are (depth,
original id) from stable sorts.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from autovfx_tpu.core import cameras as JC
from autovfx_tpu.ops import binning as JB
from autovfx_tpu.ops import projection as JPr
from autovfx_tpu.utils.synthetic import make_garden_like
from autovfx_tpu_torch.ops import binning, blend_cuda, fill_cuda, projection

W, H = 128, 96
BUDGET = 1 << 17


@pytest.fixture(scope="module")
def jax_scene():
    g = make_garden_like(20_000, extent=2.67)
    cam = JC.look_at_camera(
        [2.6, 0.0, 1.4], [0, 0, 0.2], [0, 0, 1],
        fx=96.0, fy=96.0, width=W, height=H,
    )
    return g, cam


def carry_splats(s):
    return projection.Splats2D(*[torch.tensor(np.asarray(x)) for x in s])


@pytest.mark.parametrize("fill_backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("tile", [16, 32])
def test_per_tile_gids_match_jax(jax_scene, tile, fill_backend):
    g, cam = jax_scene
    js = JPr.preprocess(g, cam, tile=tile)
    jb = JB.bin_splats(js, W, H, BUDGET, tile=tile, chunk=256,
                       fill_backend=fill_backend, pad_mode="chunk")
    pb = binning.bin_splats(carry_splats(js), W, H, BUDGET, tile=tile)

    n = g.capacity
    assert int(pb.total_dups) == int(jb.total_dups) > 10_000
    assert not bool(pb.overflow) and not bool(jb.overflow)
    assert (pb.num_tiles_x, pb.num_tiles_y) == (jb.num_tiles_x,
                                                jb.num_tiles_y)
    j_gid = np.asarray(jb.gid)
    starts = np.asarray(jb.tile_start)
    lens = np.asarray(jb.tile_chunks) * 256
    p_gid = pb.gid.numpy()
    rng = pb.tile_range.numpy()
    for t in range(pb.tile_range.shape[0]):
        seg = j_gid[starts[t]: starts[t] + lens[t]]
        np.testing.assert_array_equal(p_gid[rng[t, 0]: rng[t, 1]],
                                      seg[seg != n], err_msg=f"tile {t}")
    # every kept duplicate carries its range's tile id, sentinels after
    tiles = np.repeat(np.arange(len(rng)), rng[:, 1] - rng[:, 0])
    np.testing.assert_array_equal(pb.tile.numpy()[: len(tiles)], tiles)
    assert (pb.tile.numpy()[len(tiles):] == len(rng)).all()
    assert (p_gid[len(tiles):] == n).all()


def test_overflow_truncates_flags_and_stays_finite(jax_scene):
    g, cam = jax_scene
    s = carry_splats(JPr.preprocess(g, cam, tile=16))
    need = int(binning.required_budget(s))
    budget = need // 3
    b = binning.bin_splats(s, W, H, budget, tile=16)
    assert bool(b.overflow) and int(b.total_dups) == need
    rng = b.tile_range.numpy()
    assert rng[-1, 1] == budget  # every slot kept, none past the budget
    assert (rng[1:, 0] == rng[:-1, 1]).all()
    color, depth, alpha = blend_cuda.blend(b, s, W, H, 16)
    for x in (color, depth, alpha):
        assert torch.isfinite(x).all()
    assert float(alpha.max()) > 0.1


def test_duplicate_plain_matches_loop():
    """The repeat_interleave expansion vs a per-Gaussian loop, including
    culled splats and a budget that cuts a rect in half."""
    rng = np.random.default_rng(3)
    n, tiles_x, tiles_y = 40, 7, 5
    x0 = rng.integers(0, tiles_x, n)
    y0 = rng.integers(0, tiles_y, n)
    x1 = np.minimum(x0 + rng.integers(1, 4, n), tiles_x)
    y1 = np.minimum(y0 + rng.integers(1, 3, n), tiles_y)
    area = (x1 - x0) * (y1 - y0)
    area[rng.random(n) < 0.3] = 0
    depth = rng.uniform(0.3, 9.0, n).astype(np.float32)
    budget = int(area.sum()) - 3
    keys, gids = [], []
    for i in range(n):
        if area[i] == 0:
            continue
        for ty in range(y0[i], y1[i]):
            for tx in range(x0[i], x1[i]):
                bits = int(np.float32(depth[i]).view(np.uint32))
                keys.append(((ty * tiles_x + tx) << 32) | bits)
                gids.append(i)
    t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt)
    counts = t(area, torch.int32)
    starts = torch.cumsum(counts, 0) - counts
    k, gi = fill_cuda.duplicate_with_keys(
        counts, starts, t(np.stack([x0, y0], 1), torch.int32),
        t(np.stack([x1, y1], 1), torch.int32), t(depth, torch.float32),
        tiles_x, tiles_x * tiles_y, budget,
    )
    assert k.tolist() == keys[:budget]
    assert gi.tolist() == gids[:budget]


def expand_by_search(counts, starts, tile_min, tile_max, depth, tiles_x: int,
                     n_tiles: int, budget: int, block: int):
    """Kernel 2's load-balanced expansion (``csrc/duplicate.cu``), written
    plainly: each block of ``block`` consecutive Gaussians owns the slots
    from its first start to its last end (cut at the budget), and finds
    each slot's Gaussian as the last of its starts <= the slot; the slots
    from min(total, budget) on hold the sentinel."""
    n = counts.shape[0]
    keys = torch.empty(budget, dtype=torch.int64)
    gids = torch.empty(budget, dtype=torch.int32)
    total = int(starts[-1] + counts[-1]) if n else 0
    keys[min(total, budget):] = n_tiles << 32
    gids[min(total, budget):] = n
    bits = fill_cuda.depth_bits(depth)
    for first in range(0, n, block):
        last = min(first + block, n) - 1
        lo = int(starts[first])
        hi = min(int(starts[last] + counts[last]), budget)
        if lo >= hi:
            continue
        slots = torch.arange(lo, hi)
        i = first + torch.searchsorted(starts[first:last + 1], slots,
                                       right=True) - 1
        rank = slots - starts[i]
        x0, y0 = tile_min[i, 0].long(), tile_min[i, 1].long()
        w = tile_max[i, 0].long() - x0
        dy = torch.div(rank, w, rounding_mode="floor")
        keys[slots] = (((y0 + dy) * tiles_x + x0 + rank - dy * w) << 32) \
            | bits[i]
        gids[slots] = i.to(torch.int32)
    return keys, gids


@pytest.mark.parametrize("block", [256, 7])
@pytest.mark.parametrize("case", cs.DUPLICATE_CASES)
def test_load_balanced_expansion_matches_plain(case, block):
    """The search over block starts lands on the live Gaussian of every
    slot, past culled ones, and the sentinel fills the rest, bit for bit
    as the ``repeat_interleave`` expansion."""
    args = cs.duplicate_case(case, "cpu")
    counts, starts, budget = args[0], args[1], args[-1]
    if case == "every Gaussian culled":
        assert int(counts.abs().max()) == 0
    elif counts.numel():
        assert (counts == 0).any() and int(counts.max()) == 41 * 27
    keys, gids = expand_by_search(*args, block=block)
    want_keys, want_gids = fill_cuda.duplicate_with_keys_plain(*args)
    assert torch.equal(keys, want_keys) and torch.equal(gids, want_gids)
    total = int(counts.sum())
    if case == "a budget cut mid-rect":
        assert budget < total and int(gids[-1]) == 300  # inside its rect
    if case == "zero counts and a sentinel tail":
        assert budget > total and int(gids[-1]) == counts.shape[0]


def test_budget_helpers(jax_scene):
    g, cam = jax_scene
    s = carry_splats(JPr.preprocess(g, cam, tile=32))
    need = int(binning.required_budget(s))
    assert need == int(s.tiles_touched.sum())
    b = binning.round_budget(need, slack=1.06)
    assert b % 4096 == 0 and b >= need * 1.06
    assert not bool(binning.bin_splats(s, W, H, b, tile=32).overflow)
    with pytest.raises(ValueError):
        binning.bin_splats(s, W, H, 2**31, tile=32)
