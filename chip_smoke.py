#!/usr/bin/env python3
"""Drive the PyTorch port's novel-view render on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports ``autovfx_tpu_torch`` from the directory this script lives
in (never JAX, never ``autovfx_tpu``) and

1. checks the machine (a CUDA device, its name and power limit, the
   toolchain) and builds the package's CUDA kernels from ``csrc/``;
2. holds each kernel against its plain PyTorch version on a 20k-splat
   garden-like scene at 128×96, at tile 16 and tile 32;
3. renders the novel-view operating point: 1M splats written to and read
   back from a PLY file, the 8-camera ring at 1296×840, tile 32, with a
   duplicate budget sized from the views; checks the frames, that every
   kernel ran on that path, and 64 seeded tiles per frame against the
   plain blend; and times the frame and its stages with CUDA events, the
   device's busy share with the profiler, and each kernel's device time
   beside its plain version's.

Any failed check raises, so the exit code is not 0.  The last three
lines of output are a JSON object of the kernels, the card's name and
power limit as ``nvidia-smi`` prints them, and a JSON object that says
the run passed.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from importlib import metadata, util
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
DEVICE = "cuda"

# operating point (the JAX package's bench.py config 1)
N_SPLATS = 1_000_000
EXTENT = 2.67
WIDTH, HEIGHT, TILE = 1296, 840, 32
N_CAMS = 8
BUDGET_SLACK = 1.06
WARMUP, TIMED = 3, 20
CHECK_TILES = 64  # seeded tiles per frame checked against the plain blend
PLAIN_TILE_BATCH = 16  # tiles per plain-blend call (bounds its memory)

# kernel-vs-plain scene (the JAX package's golden scene, numpy-made)
SMALL_SPLATS, SMALL_W, SMALL_H = 20_000, 128, 96

# tolerances of the kernel checks
MEAN2D_ATOL = 1e-4  # px, plus 2 float32 ulps of the coordinate
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6  # conic, color, depth
OPACITY_ATOL = 1e-6
INT_EXACT_FRACTION = 0.999  # radius / tile rect / tiles_touched
BLEND_PSNR_DB = 70.0
ALPHA_Q999, ALPHA_MAX = 2e-3, 0.05  # the exact-freeze boundary class

KERNELS = {
    "preprocess": dict(
        source="autovfx_tpu_torch/csrc/preprocess.cu",
        replaces="autovfx_tpu/ops/preprocess_pallas.py:135",
    ),
    "duplicate_with_keys": dict(
        source="autovfx_tpu_torch/csrc/duplicate.cu",
        replaces="autovfx_tpu/ops/fill_pallas.py:48",
    ),
    "blend_fwd": dict(
        source="autovfx_tpu_torch/csrc/blend_fwd.cu",
        replaces="autovfx_tpu/ops/blend_pallas.py:140",
    ),
}


def import_port():
    """The port from this script's own directory, and nothing else."""
    sys.path.insert(0, str(HERE))
    import autovfx_tpu_torch

    where = Path(autovfx_tpu_torch.__file__).resolve()
    if HERE not in where.parents:
        raise SystemExit(f"autovfx_tpu_torch came from {where}, not {HERE}")
    return autovfx_tpu_torch


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def sync() -> None:
    torch.cuda.synchronize()


def run_cmd(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls, CUDA events
    around each call (host launch time included)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, kernel: str | None = None) -> float:
    """Device milliseconds per call of ``fn``: the profiler's sum over
    the kernels, memsets and copies it puts on the card, or only over the
    kernels whose name contains ``kernel``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and (kernel is None or kernel in e.name))
    check(us > 0, f"the profiler saw no device time for {kernel or fn}")
    return us / 1e3 / reps


def in_turns(plain, kernel, reps: int, name: str) -> tuple[float, float]:
    """(kernel ms, plain ms) of device time, timed plain, kernel, kernel,
    plain; the kernel's time is its own launch, the plain version's all
    the device work it does."""
    p1, k1, k2, p2 = (device_ms(plain, reps), device_ms(kernel, reps, name),
                      device_ms(kernel, reps, name), device_ms(plain, reps))
    return (k1 + k2) / 2, (p1 + p2) / 2


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.double() - b.double()) ** 2).item()
    return -10.0 * np.log10(max(mse, 1e-30))


# ---- kernel checks -----------------------------------------------------------


def check_preprocess(got, want, what: str) -> float:
    """Kernel 1 against the plain preprocess; returns the max abs error
    of the float fields on the splats both call live."""
    live = (got.tiles_touched > 0) & (want.tiles_touched > 0)
    errs = []
    d = (got.mean2d - want.mean2d).abs()[live]
    tol = MEAN2D_ATOL + 2.0**-22 * want.mean2d.abs()[live]
    check(bool((d <= tol).all()), f"{what}: mean2d off by {d.max().item()}")
    errs.append(d.max().item())
    for f in ("conic", "color", "depth"):
        a, b = getattr(got, f)[live], getattr(want, f)[live]
        d = (a - b).abs()
        check(bool((d <= FLOAT_ATOL + FLOAT_RTOL * b.abs()).all()),
              f"{what}: {f} off by {d.max().item()}")
        errs.append(d.max().item())
    d = (got.opacity - want.opacity).abs()
    check(d.max().item() <= OPACITY_ATOL, f"{what}: opacity off by {d.max()}")
    errs.append(d.max().item())
    for f in ("radius", "tile_min", "tile_max", "tiles_touched"):
        d = (getattr(got, f).long() - getattr(want, f).long()).abs()
        d = d.reshape(d.shape[0], -1).amax(dim=1)
        exact = (d == 0).double().mean().item()
        check(exact >= INT_EXACT_FRACTION, f"{what}: {f} exact on {exact}")
        if f != "tiles_touched":  # an area moves by a rect's side
            check(d.max().item() <= 1, f"{what}: {f} off by {d.max()}")
    area = (got.tile_max - got.tile_min).prod(dim=1)
    check(bool((got.tiles_touched == torch.where(got.radius > 0, area, 0))
               .all()), f"{what}: tiles_touched is not the rect area")
    return max(errs)


def check_duplicates(P, splats, tiles_x, n_tiles, budget, what) -> float:
    """Kernel 2 against its repeat_interleave version, bit for bit, raw
    and sorted."""
    counts = splats.tiles_touched
    starts = torch.cumsum(counts, 0) - counts
    args = (counts, starts, splats.tile_min, splats.tile_max, splats.depth,
            tiles_x, n_tiles, budget)
    k_keys, k_gids = P.ops.fill_cuda.duplicate_with_keys_kernel(*args)
    p_keys, p_gids = P.ops.fill_cuda.duplicate_with_keys_plain(*args)
    check(torch.equal(k_keys, p_keys) and torch.equal(k_gids, p_gids),
          f"{what}: duplicate keys/gids differ")
    ks, kg = P.ops.binning.sort_duplicates(k_keys, k_gids)
    ps, pg = P.ops.binning.sort_duplicates(p_keys, p_gids)
    check(torch.equal(ks >> 32, ps >> 32) and torch.equal(kg, pg),
          f"{what}: sorted (tile, gid) differ")
    return float((k_keys - p_keys).abs().max().item())


def blend_subset(P, binned, splats, tiles, tile):
    """The plain blend of ``tiles``, in batches."""
    parts = [P.ops.blend_ref.blend_tiles_ref(binned, splats, tile,
                                             tiles[i:i + PLAIN_TILE_BATCH])
             for i in range(0, len(tiles), PLAIN_TILE_BATCH)]
    return [torch.cat(x) for x in zip(*parts)]


def check_blend(P, binned, splats, images, tiles, width, height, tile,
                what) -> float:
    """Kernel 3's images on ``tiles`` against the plain blend."""
    tx, ty = binned.num_tiles_x, binned.num_tiles_y
    split = lambda img: P.ops.blend_ref.split_tiles(img, tx, ty, tile)[tiles]
    inside = split(torch.ones(height, width, device=images[0].device)) > 0
    ref = blend_subset(P, binned, splats, tiles, tile)
    color, alpha = split(images[0])[inside], split(images[2])[inside]
    r_color, r_alpha = ref[0][inside], ref[2][inside]
    db = psnr(color, r_color)
    check(db > BLEND_PSNR_DB, f"{what}: color PSNR {db:.1f} dB")
    da = (alpha - r_alpha).abs()
    q = torch.quantile(da.double(), 0.999).item()
    check(q < ALPHA_Q999 and da.max().item() < ALPHA_MAX,
          f"{what}: alpha q99.9 {q}, max {da.max().item()}")
    return (color - r_color).abs().max().item()


def small_checks(P) -> None:
    from autovfx_tpu_torch.core.cameras import look_at_camera
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    ops = P.ops
    g = make_garden_like(SMALL_SPLATS, seed=0, extent=EXTENT, device=DEVICE)
    cam = look_at_camera([2.6, 0.0, 1.4], [0, 0, 0.2], [0, 0, 1], fx=96.0,
                         fy=96.0, width=SMALL_W, height=SMALL_H,
                         device=DEVICE)
    for tile in (16, 32):
        what = f"{SMALL_SPLATS} splats {SMALL_W}x{SMALL_H} tile {tile}"
        s = ops.preprocess_cuda.preprocess_kernel(g, cam, tile=tile)
        e1 = check_preprocess(s, ops.projection.preprocess(g, cam, tile=tile),
                              what)
        sync()
        tx, ty = ops.projection.num_tiles(SMALL_W, SMALL_H, tile)
        budget = ops.binning.round_budget(
            int(ops.binning.required_budget(s)))
        e2 = check_duplicates(P, s, tx, tx * ty, budget, what)
        sync()
        b = ops.binning.bin_splats(s, SMALL_W, SMALL_H, budget, tile=tile)
        imgs = ops.blend_cuda.blend_kernel(b, s, SMALL_W, SMALL_H, tile)
        all_tiles = torch.arange(tx * ty, device=DEVICE)
        e3 = check_blend(P, b, s, imgs, all_tiles, SMALL_W, SMALL_H, tile,
                         what)
        sync()
        print(f"check {what}: preprocess max err {e1:.3g}, duplicates "
              f"bit-equal ({e2:.0f}), blend max color err {e3:.3g}: ok")


# ---- operating point ---------------------------------------------------------


def ring_cameras():
    from autovfx_tpu_torch.core.cameras import look_at_camera

    return [
        look_at_camera([2.6 * np.cos(a), 2.6 * np.sin(a), 1.4],
                       [0.0, 0.0, 0.2], [0.0, 0.0, 1.0],
                       fx=960.98 * WIDTH / 1296.0, fy=963.15 * WIDTH / 1296.0,
                       width=WIDTH, height=HEIGHT, device=DEVICE)
        for a in np.linspace(0, 2 * np.pi, N_CAMS, endpoint=False)
    ]


def load_scene():
    from autovfx_tpu_torch.core import ply_io
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    t0 = time.perf_counter()
    g = make_garden_like(N_SPLATS, seed=0, extent=EXTENT)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "garden_like.ply")
        ply_io.save_ply(path, g)
        size = os.path.getsize(path)
        g = ply_io.load_ply(path, device=DEVICE)
    print(f"scene: {g.capacity} splats through a {size / 2**20:.1f} MiB PLY "
          f"in {time.perf_counter() - t0:.1f} s")
    return g


def counters(ops) -> dict:
    return {
        "preprocess": ops.preprocess_cuda.launches,
        "duplicate_with_keys": ops.fill_cuda.launches,
        "blend_fwd": ops.blend_cuda.launches,
    }


def reset_counters(ops) -> None:
    ops.preprocess_cuda.launches = 0
    ops.fill_cuda.launches = 0
    ops.blend_cuda.launches = 0


def operating_point(P, card: str) -> list[dict]:
    ops = P.ops
    g = load_scene()
    cams = ring_cameras()
    worst = max(int(ops.binning.required_budget(
        ops.preprocess_cuda.preprocess(g, c, tile=TILE))) for c in cams)
    budget = ops.binning.round_budget(worst, slack=BUDGET_SLACK)
    config = P.RasterConfig(dup_budget=budget, tile=TILE)
    bg = torch.zeros(3, device=DEVICE)
    print(f"duplicates: worst view {worst}, budget {budget}")

    # the main path, counted
    sync()
    reset_counters(ops)
    frames = [P.rasterize(g, c, bg=bg, config=config) for c in cams]
    sync()
    launches = counters(ops)
    for name, n in launches.items():
        check(n >= N_CAMS, f"{name} launched {n} times for {N_CAMS} frames")
    for i, f in enumerate(frames):
        for x in (f.color, f.depth, f.alpha):
            check(bool(torch.isfinite(x).all()), f"frame {i}: not finite")
        check(not bool(f.overflow), f"frame {i}: duplicate budget overflow")
        check(f.color.shape == (HEIGHT, WIDTH, 3), f"frame {i}: shape")
        check(f.alpha.mean().item() > 0.5,
              f"frame {i}: mean alpha {f.alpha.mean().item()}")
    print("frames: " + ", ".join(
        f"{f.alpha.mean().item():.3f}" for f in frames) + " mean alpha, "
        f"launches {launches}")

    # kernels against their plain versions at the main path's shapes
    tx, ty = ops.projection.num_tiles(WIDTH, HEIGHT, TILE)
    rng = np.random.default_rng(0)
    err = {}
    for i, (f, cam) in enumerate(zip(frames, cams)):
        what = f"frame {i}"
        s = ops.preprocess_cuda.preprocess_kernel(g, cam, tile=TILE)
        if i == 0:
            err["preprocess"] = check_preprocess(
                s, ops.projection.preprocess(g, cam, tile=TILE), what)
            err["duplicate_with_keys"] = check_duplicates(
                P, s, tx, tx * ty, budget, what)
        b = ops.binning.bin_splats(s, WIDTH, HEIGHT, budget, tile=TILE)
        tiles = torch.from_numpy(
            rng.choice(tx * ty, CHECK_TILES, replace=False)).to(DEVICE)
        images = (f.color, f.depth, f.alpha)  # bg is zero
        err["blend_fwd"] = max(err.get("blend_fwd", 0.0), check_blend(
            P, b, s, images, tiles, WIDTH, HEIGHT, TILE, what))
        sync()
    print(f"checks at {N_SPLATS} splats {WIDTH}x{HEIGHT} tile {TILE}: "
          f"{CHECK_TILES} tiles/frame against the plain blend: ok")

    # frame time
    def frame(i):
        return P.rasterize(g, cams[i % N_CAMS], bg=bg, config=config)

    for i in range(WARMUP):
        frame(i)
    sync()
    frame_ms = [cuda_ms(lambda i=i: frame(i), 1) for i in range(TIMED)]
    median = statistics.median(frame_ms)
    print(f"[{card}] frame {WIDTH}x{HEIGHT} tile {TILE}, {N_SPLATS} splats: "
          f"median {median:.3f} ms over {TIMED} frames "
          f"(min {min(frame_ms):.3f}, max {max(frame_ms):.3f}); "
          f"{1000.0 / median:.1f} frames/s")
    run = lambda: [frame(i) for i in range(TIMED)]
    streamed = cuda_ms(run, 3) / TIMED
    busy = device_ms(run, 1) / TIMED
    print(f"[{card}] {TIMED} frames back to back: {streamed:.3f} ms/frame, "
          f"device busy {busy:.3f} ms/frame, idle share "
          f"{1.0 - busy / streamed:.3f}")

    # stages, as bin_splats runs them
    stages = {k: [] for k in ("preprocess", "scan+expand", "sort", "ranges",
                              "blend")}
    for i in range(TIMED):
        cam = cams[i % N_CAMS]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        s = ops.preprocess_cuda.preprocess(g, cam, tile=TILE)
        ev[1].record()
        keys, gids, total = ops.binning.expand_duplicates(s, tx, tx * ty,
                                                          budget)
        ev[2].record()
        keys_s, gid_s = ops.binning.sort_duplicates(keys, gids)
        ev[3].record()
        rng_t = ops.binning.tile_ranges(keys_s, tx * ty)
        tile_s = (keys_s >> 32).to(torch.int32)
        ev[4].record()
        b = ops.binning.BinnedSplats(gid_s, tile_s, rng_t, tx, ty, total,
                                     total > budget)
        ops.blend_cuda.blend(b, s, WIDTH, HEIGHT, TILE)
        ev[5].record()
        ev[5].synchronize()
        for k, (a, z) in zip(stages, zip(ev, ev[1:])):
            stages[k].append(a.elapsed_time(z))
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    print(f"[{card}] stages (median ms over {TIMED} frames): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items())
        + f"; sum {sum(stage_ms.values()):.3f}")

    # each kernel beside its plain version, at the first view's shapes
    cam = cams[0]
    s = ops.preprocess_cuda.preprocess_kernel(g, cam, tile=TILE)
    counts = s.tiles_touched
    starts = torch.cumsum(counts, 0) - counts
    dup_args = (counts, starts, s.tile_min, s.tile_max, s.depth, tx, tx * ty,
                budget)
    b = ops.binning.bin_splats(s, WIDTH, HEIGHT, budget, tile=TILE)
    all_tiles = torch.arange(tx * ty, device=DEVICE)
    ms = {}
    ms["preprocess"] = in_turns(
        lambda: ops.projection.preprocess(g, cam, tile=TILE),
        lambda: ops.preprocess_cuda.preprocess_kernel(g, cam, tile=TILE),
        10, "preprocess_kernel")
    ms["duplicate_with_keys"] = in_turns(
        lambda: ops.fill_cuda.duplicate_with_keys_plain(*dup_args),
        lambda: ops.fill_cuda.duplicate_with_keys_kernel(*dup_args),
        10, "duplicate_kernel")
    ms["blend_fwd"] = in_turns(
        lambda: blend_subset(P, b, s, all_tiles, TILE),
        lambda: ops.blend_cuda.blend_kernel(b, s, WIDTH, HEIGHT, TILE),
        2, "blend_kernel")
    for k, (k_ms, p_ms) in ms.items():
        print(f"[{card}] {k}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
              f"of device time (x{p_ms / k_ms:.1f})")
    return [
        dict(name=k, route="cuda", **KERNELS[k], launches=launches[k],
             max_abs_err=err[k], ms=ms[k][0], plain_ms=ms[k][1])
        for k in KERNELS
    ]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is False")
    P = import_port()
    from autovfx_tpu_torch.ops import _build

    card = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("nvcc: " + run_cmd([_build.find_nvcc(), "--version"])
          .splitlines()[-1])
    print("triton: " + (metadata.version("triton")
                        if util.find_spec("triton") else "not installed"))
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib}")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())
    _build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    small_checks(P)
    kernels = operating_point(P, card)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
