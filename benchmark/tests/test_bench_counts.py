"""The frozen work counters and the plain blend's counts, against views
counted by hand: a direct loop over pixels and splats."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import scene, work
from benchmark.reference import raster

TILE = 16


def splats_at(points, scales, opacity):
    n = len(points)
    logit = math.log(opacity / (1 - opacity))
    return {"xyz": torch.tensor(points, dtype=torch.float32),
            "sh_dc": torch.zeros(n, 3), "sh_rest": torch.zeros(n, 15, 3),
            "log_scales": torch.log(torch.tensor(scales, dtype=torch.float32)),
            "quats": torch.tensor([[1.0, 0, 0, 0]] * n),
            "opacity_logit": torch.full((n,), logit),
            "active": torch.ones(n, dtype=torch.bool)}


def by_hand(s: raster.Splats, width: int, height: int):
    """Blended pairs and the duplicates up to each tile's last blended one,
    pixel by pixel in depth order, as renderCUDA walks them."""
    order = sorted(range(len(s.depth)), key=lambda i: float(s.depth[i]))
    tiles_x = (width + TILE - 1) // TILE
    last = {}
    pairs = 0
    for y in range(height):
        for x in range(width):
            t_pix, tile = 1.0, (y // TILE) * tiles_x + x // TILE
            k = 0
            for i in order:
                tx0, ty0 = s.tile_min[i].tolist()
                tx1, ty1 = s.tile_max[i].tolist()
                if not (tx0 <= x // TILE < tx1 and ty0 <= y // TILE < ty1):
                    continue
                k += 1
                dx = float(s.mean2d[i, 0]) - x
                dy = float(s.mean2d[i, 1]) - y
                a, b, c = s.conic[i].tolist()
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = min(0.99, float(s.opacity[i]) * math.exp(power))
                if power > 0 or alpha < 1 / 255:
                    continue
                if t_pix * (1 - alpha) < 1e-4:
                    break
                t_pix *= 1 - alpha
                pairs += 1
                last[tile] = max(last.get(tile, 0), k)
    return pairs, sum(last.values())


@pytest.mark.parametrize("points", [
    [[0.0, 0.0, 0.0]],
    [[0.0, 0.0, 0.0], [0.05, 0.02, 0.3]],
    [[0.1, -0.05, 0.0], [0.0, 0.0, 0.2], [-0.12, 0.04, -0.1]],
])
def test_plain_blend_counts_match_a_count_by_hand(points):
    view = scene.look_at([0.0, -2.0, 0.0], [0, 0, 0], [0, 0, 1], 40.0, 40.0,
                         48, 32)
    g = splats_at(points, [[0.08, 0.06, 0.05]] * len(points), 0.9)
    cam = raster.cam_of(view, "cpu")
    s = raster.preprocess(g, cam, TILE)
    b = raster.bin_splats(s, 48, 32, TILE)
    _, c = raster.blend(s, b, 48, 32, TILE, counts=True)
    pairs, reached = by_hand(s, 48, 32)
    assert c.blended == pairs > 0
    assert c.dups_reached == reached
    assert c.pixels == 48 * 32 and c.tiles == 3 * 2
    assert c.live == len(points)
    assert c.dups == int(s.tiles_touched.sum())


def test_work_counters_by_hand():
    c = raster.Counts(pixels=100, tiles=4, dups_reached=10, blended=50,
                      live=3, dups=12)
    assert work.blend(c) == (8 * 4 + 4 * 10 + 40 * 3 + 20 * 100, 12 * 50, 50)
    assert work.blend(c, train=True)[0] == 8 * 4 + 4 * 10 + 40 * 3 + 28 * 100
    assert work.blend(c, backward=True) == (
        8 * 4 + 4 * 10 + 80 * 3 + 28 * 100, 50 * 50, 100)
    assert work.params_per_splat(15) == 59
    assert work.preprocess(2, 15) == (2 * (4 * 59 + 1 + 4 * 16) + 84, 400, 0)
    assert work.duplicate(5, 3, 7) == (20 + 28 * 3 + 84, 0, 0)
    assert work.adam(2, 15) == (2 * (4 * 59 * 7 + 1), 0, 0)
    assert work.preprocess_bwd(1, 15) == (4 * (59 + 11 + 59) + 84, 400, 0)


def test_bound_takes_the_slowest_rate():
    assert work.bound_s((3.35e12, 0, 0)) == pytest.approx(1.0)
    assert work.bound_s((0, 67e12, 0)) == pytest.approx(1.0)
    assert work.bound_s((1, 1, 132 * 16 * 1.98e9)) == pytest.approx(1.0)


def test_scene_is_seeded_and_sized():
    import json

    from benchmark.harness import ROOT
    cfg = json.load(open(ROOT / "benchmark/configs/garden-1m.json"))
    cfg = dict(cfg, splats=1001)
    a, b = scene.garden(cfg, 2**31 + 5, "cpu"), scene.garden(cfg, 2**31 + 5,
                                                             "cpu")
    c = scene.garden(cfg, 7, "cpu")
    assert all(torch.equal(a[f], b[f]) for f in scene.FIELDS)
    assert not torch.equal(a["xyz"], c["xyz"])
    assert a["xyz"].shape == (1001, 3) and a["sh_rest"].shape == (1001, 15, 3)
    ground = a["xyz"][:500]
    assert float(ground[:, 2].abs().max()) < 0.5
    pos, rot = scene.cube_drop(cfg["edit"], 8, 3)
    rest = cfg["edit"]["ground_z"] + cfg["edit"]["cube_half"]
    assert pos[0, 0, 2] == pytest.approx(cfg["edit"]["drop_z"])
    assert float(pos[:, 0, 2].min()) >= rest - 1e-6
    assert np.allclose(rot[:, 0] @ rot[:, 0].transpose(0, 2, 1), np.eye(3),
                       atol=1e-6)
