#!/usr/bin/env python3
"""Drive the PyTorch port's novel-view render and training on one NVIDIA GPU.

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
   beside its plain version's;
4. holds the two backward kernels (kernel 4 and the preprocess backward)
   against their plain versions on the small scene at tile 16 and 32,
   and again on a saturated copy of it where the 0.99 alpha clamp binds;
5. trains at the operating point of the JAX package's bench.py:557-583:
   the 1M-splat scene padded to 1.25M slots, the same ring and tile,
   from a seeded perturbation of it toward its own renders: 30 steps, a
   densification, an opacity reset and 5 more steps, checking that each
   kernel of the step launched once per step (the training blend, not
   the novel-view one), the state stays finite, the loss on camera 0
   falls and the densify counts add up; then the backward kernels on
   64 seeded tiles (and every splat) of a full-size view against their
   plain versions;
6. times a training step with CUDA events, the device's idle share
   across 20 steps and their device time split by stage (both from the
   profiler), the peak device memory, and each backward kernel's device
   time beside its plain version's.

Any failed check raises, so the exit code is not 0.  The last three
lines of output are a JSON object of the kernels (with each path's own
launch counts), the card's name and power limit as ``nvidia-smi``
prints them, and a JSON object that says the run passed.
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
KERNEL_REPS = 10  # kernel launches per profiler session
PROFILE_PAD_S = 0.5  # idle seconds at each end of a profiler session
OPEN_SPIN_CYCLES = 500_000_000  # the opening marker's spin, ~0.25 s
OPEN_MARKERS = 4  # marker launches that open a session (the spin first)
SESSION_TRIES = 3  # profiler sessions taken before a lost record fails
MAX_LOST_SHARE = 1e-3  # of a session's kernel records (1 of 4800 went)

# kernel-vs-plain scene (the JAX package's golden scene, numpy-made)
SMALL_SPLATS, SMALL_W, SMALL_H = 20_000, 128, 96

# training operating point (the JAX package's bench.py:557-583, config 2)
CAPACITY = 1_250_000
TRAIN_STEPS, AFTER_DENSIFY_STEPS = 30, 5
DC_NOISE, LOGIT_SHIFT = 0.3, -1.0  # the perturbation training starts from
TRAIN_TIMED = 20
# The training step's device time by stage, from the records of the
# timed steps in the order the card ran them (one stream): a kernel of
# the port is its own stage and opens the stage of the records after it.
TRAIN_STAGES = (  # kernel name, its stage, the stage it opens
    ("preprocess_bwd_kernel", "preprocess_bwd", "adam+stats"),
    ("blend_bwd_kernel", "blend_bwd", "bwd glue"),
    ("preprocess_kernel", "preprocess", "binning"),
    ("blend_kernel", "blend_fwd", "loss"),
)

# tolerances of the kernel checks
MEAN2D_ATOL = 1e-4  # px, plus 2 float32 ulps of the coordinate
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6  # conic, color, depth
OPACITY_ATOL = 1e-6
INT_EXACT_FRACTION = 0.999  # radius / tile rect / tiles_touched
BLEND_PSNR_DB = 70.0
ALPHA_Q999, ALPHA_MAX = 2e-3, 0.05  # the exact-freeze boundary class
# Backward kernels: per field, max |kernel - plain| over the plain
# version's largest magnitude (the normalisation of the JAX package's
# tests/test_pallas_blend.py:181-186).  The preprocess backward is the
# same arithmetic as autograd in another order (1e-6 on the CPU); kernel
# 4 rebuilds T by division and sums in float32 where the plain version
# takes float64 prefix sums, and adds with atomics in no fixed order.
# Where the two decide a duplicate otherwise within float32 rounding
# (blend_ref.ambiguous_pixels) the image gradients are zeroed: such a
# pixel moves a large splat's conic gradient by ~1e-2 of its largest
# (7e-3 in one full-size check on an H100).
PRE_BWD_TOL = 1e-4
BLEND_BWD_TOL = 5e-4
MAX_AMBIGUOUS_SHARE = 1e-2  # of the checked pixels
SATURATED_LOGIT = 5.0  # opacity 0.9933: the 0.99 clamp binds

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
    "blend_bwd": dict(
        source="autovfx_tpu_torch/csrc/blend_bwd.cu",
        replaces="autovfx_tpu/ops/blend_pallas_bwd.py:62",
    ),
    "preprocess_bwd": dict(
        source="autovfx_tpu_torch/csrc/preprocess_bwd.cu",
        replaces="XLA autodiff of autovfx_tpu/ops/projection.py:74",
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


def profiled(fn, reps: int) -> list:
    """The profiler's device records (kernels, memsets, copies) of
    ``reps`` calls of ``fn``, after one call outside the session.

    The profiler keeps only the device records that fall inside its
    session on the host's clock.  The host's and the card's clocks
    disagree by milliseconds, and by more after a long session, so a
    session can lose records (on an H100, the short sessions after a 2-4 s
    one lost all of theirs, and with idle padding alone, sessions still
    lost their first two records).  So a session is padded with idle
    time, opens with ``OPEN_MARKERS`` marker kernels (the first a spin
    that holds the card ~0.25 s) and closes with one, all of which may
    take such a loss, and is taken again, ``SESSION_TRIES`` times at
    most, until the launches between the markers whose device record (by
    correlation id) is missing are at most ``MAX_LOST_SHARE`` of them:
    none in a short session.  Each missing record is printed with its
    neighbours."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(SESSION_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            torch.cuda._sleep(OPEN_SPIN_CYCLES)  # markers: spin_kernel
            for _ in range(OPEN_MARKERS - 1):
                torch.cuda._sleep(1)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1)
            sync()
            time.sleep(PROFILE_PAD_S)
        events = prof.profiler.kineto_results.events()
        device = [e for e in events if e.device_type() == DeviceType.CUDA]
        launches = sorted((e for e in events
                           if e.device_type() == DeviceType.CPU
                           and "Launch" in e.name() and "Kernel" in e.name()),
                          key=lambda e: e.start_ns())  # cu(da)Launch*Kernel*
        kernel = {e.correlation_id(): e.name() for e in device}
        n = len(launches) - OPEN_MARKERS - 1
        lost = [i for i in range(OPEN_MARKERS, OPEN_MARKERS + n)
                if launches[i].correlation_id() not in kernel]
        for i in lost[:3]:
            near = [kernel.get(launches[j].correlation_id(), "?")[:60]
                    for j in (i - 1, i + 1)]
            print(f"profiler: no device record for launch "
                  f"{i - OPEN_MARKERS + 1} of {n} "
                  f"({launches[i].name()}), between {near[0]} and {near[1]}")
        if n > 0 and len(lost) <= MAX_LOST_SHARE * n:
            break
    check(n > 0 and len(lost) <= MAX_LOST_SHARE * n,
          f"the profiler lost {len(lost)} of {n} kernel records in each of "
          f"{SESSION_TRIES} sessions")
    return sorted((e for e in device if "spin_kernel" not in e.name()),
                  key=lambda e: e.start_ns())


def device_times(fn, reps: int) -> dict[str, float]:
    """Device milliseconds per call of ``fn`` for each name the profiler
    puts on the card."""
    times = {}
    for e in profiled(fn, reps):
        ms = e.duration_ns() / 1e6 / reps
        times[e.name()] = times.get(e.name(), 0.0) + ms
    return times


def device_ms(fn, reps: int, kernel: str | None = None) -> float:
    """Device milliseconds per call of ``fn``: the profiler's sum over
    all it puts on the card, or only over the kernels whose name
    contains ``kernel``."""
    ms = sum(t for name, t in device_times(fn, reps).items()
             if kernel is None or kernel in name)
    check(ms > 0, f"the profiler saw no device time for {kernel or fn}")
    return ms


def in_turns(plain, kernel, reps: int, name: str) -> tuple[float, float]:
    """(kernel ms, plain ms) of device time, timed plain, kernel, kernel,
    plain, the plain version over ``reps`` calls and the kernel over
    ``KERNEL_REPS``; the kernel's time is its own launch, the plain
    version's all the device work it does."""
    p1, k1, k2, p2 = (device_ms(plain, reps),
                      device_ms(kernel, KERNEL_REPS, name),
                      device_ms(kernel, KERNEL_REPS, name),
                      device_ms(plain, reps))
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
    """Launches per wrapper; kernel 3's two entries apart."""
    return {
        "preprocess": ops.preprocess_cuda.launches,
        "duplicate_with_keys": ops.fill_cuda.launches,
        "blend_fwd": ops.blend_cuda.launches,
        "blend_fwd_train": ops.blend_cuda.train_launches,
        "blend_bwd": ops.blend_cuda.bwd_launches,
        "preprocess_bwd": ops.preprocess_cuda.bwd_launches,
    }


def reset_counters(ops) -> None:
    ops.preprocess_cuda.launches = 0
    ops.preprocess_cuda.bwd_launches = 0
    ops.fill_cuda.launches = 0
    ops.blend_cuda.launches = 0
    ops.blend_cuda.train_launches = 0
    ops.blend_cuda.bwd_launches = 0


def check_launches(launches: dict, want: dict, what: str) -> None:
    """Each wrapper launched exactly as often as the path should."""
    for name, n in launches.items():
        check(n == want.get(name, 0),
              f"{what}: {name} launched {n} times, not {want.get(name, 0)}")


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
    check_launches(launches, {"preprocess": N_CAMS,
                              "duplicate_with_keys": N_CAMS,
                              "blend_fwd": N_CAMS}, f"{N_CAMS} frames")
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
    return launches, err, ms


# ---- backward kernels --------------------------------------------------------


def check_fields(got, want, tol: float, what: str) -> tuple[float, float]:
    """Per field of two gradient NamedTuples: max |got - want| over the
    largest |want| must stay below ``tol``; returns the max abs error and
    the largest such ratio."""
    worst, rel = 0.0, 0.0
    for name, a, b in zip(want._fields, got, want):
        if b is None:
            continue
        check(bool(torch.isfinite(a).all()), f"{what}: d {name} not finite")
        d = (a.double() - b.double()).abs().max().item()
        scale = b.abs().max().item() + 1e-12
        check(d / scale <= tol, f"{what}: d {name} off by {d:.3g} "
              f"({d / scale:.3g} of its largest {scale:.3g})")
        worst, rel = max(worst, d), max(rel, d / scale)
    return worst, rel


def splat_grads(P, n: int, rng) -> object:
    """Random output gradients of the preprocess, (N, ...) f32 on the card."""
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(DEVICE)
    return P.ops.blend_ref.SplatGrads(mean2d=t(n, 2), conic=t(n, 3),
                                      opacity=t(n), color=t(n, 3),
                                      depth=t(n))


def image_grads(h: int, w: int, rng, keep=None):
    """Random gradients of the color, depth and alpha images; zero
    outside ``keep`` (an (H, W) bool tensor) when given."""
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(DEVICE)
    g = [t(h, w, 3), 0.1 * t(h, w), 0.2 * t(h, w)]
    if keep is not None:
        g = [g[0] * keep[..., None], g[1] * keep, g[2] * keep]
    return [x.contiguous() for x in g]


def check_preprocess_bwd(P, g, cam, tile, rng, what) -> tuple[float, float]:
    """``preprocess_bwd`` against autograd of ``projection.preprocess``
    on random output gradients; both read the plain forward's valid
    slots.  Returns ``check_fields``'s errors."""
    ops = P.ops
    s = ops.projection.preprocess(g, cam, tile=tile)
    d = splat_grads(P, g.capacity, rng)
    got = ops.preprocess_cuda.preprocess_bwd_kernel(g, cam, s.tiles_touched, d,
                                                    tile=tile)
    want = ops.preprocess_cuda.preprocess_bwd_plain(g, cam, s.tiles_touched, d,
                                                    tile=tile)
    return check_fields(got, want, PRE_BWD_TOL, f"{what} preprocess_bwd")


def plain_blend_bwd(P, binned, splats, grads, tile, tiles):
    """The plain blend backward over ``tiles``, in batches, summed."""
    parts = [P.ops.blend_ref.blend_tiles_ref_bwd(
        binned, splats, *grads, tile=tile, tiles=tiles[i:i + PLAIN_TILE_BATCH])
        for i in range(0, len(tiles), PLAIN_TILE_BATCH)]
    return type(parts[0])(*(sum(x) for x in zip(*parts)))


def check_blend_bwd(P, g, cam, tile, rng, what, tiles=None):
    """Kernel 4 over every tile against the plain backward over
    ``tiles`` (default: all), with the image gradients zeroed outside
    them and at the pixels ``blend_ref.ambiguous_pixels`` marks (at most
    ``MAX_AMBIGUOUS_SHARE`` of them); kernel 3's training variant must
    give the novel-view images.  Returns (max abs err, max error over
    the field's largest magnitude, pixels zeroed, pixels checked)."""
    ops = P.ops
    w, h = cam.width, cam.height
    s = ops.preprocess_cuda.preprocess_kernel(g, cam, tile=tile)
    budget = ops.binning.round_budget(int(ops.binning.required_budget(s)))
    b = ops.binning.bin_splats(s, w, h, budget, tile=tile)
    images, state = ops.blend_cuda.blend_train_kernel(b, s, w, h, tile)
    for x, y in zip(images, ops.blend_cuda.blend_kernel(b, s, w, h, tile)):
        check((x - y).abs().max().item() <= 1e-6,
              f"{what}: the training blend's images differ")
    tx, ty = b.num_tiles_x, b.num_tiles_y
    if tiles is None:
        tiles = torch.arange(tx * ty, device=DEVICE)
    chosen = torch.zeros(tx * ty, tile * tile, dtype=torch.bool,
                         device=DEVICE)
    chosen[tiles] = True
    marked = torch.zeros_like(chosen)
    for i in range(0, len(tiles), PLAIN_TILE_BATCH):
        batch = tiles[i:i + PLAIN_TILE_BATCH]
        marked[batch] = ops.blend_ref.ambiguous_pixels(b, s, tile, batch)
    image = lambda x: ops.blend_ref.assemble_image(x, tx, ty, w, h, tile)
    keep = image(chosen & ~marked)
    n_px, n_zeroed = int(image(chosen).sum()), int(image(marked).sum())
    check(n_zeroed <= MAX_AMBIGUOUS_SHARE * n_px,
          f"{what}: {n_zeroed} of {n_px} pixels decide within rounding")
    grads = image_grads(h, w, rng, keep)
    got = ops.blend_cuda.blend_bwd_kernel(b, s, state, *grads, w, h, tile)
    want = plain_blend_bwd(P, b, s, grads, tile, tiles)
    return (*check_fields(got, want, BLEND_BWD_TOL, f"{what} blend_bwd"),
            n_zeroed, n_px)


def small_grad_checks(P) -> dict:
    import dataclasses

    from autovfx_tpu_torch.core.cameras import look_at_camera
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    g = make_garden_like(SMALL_SPLATS, seed=0, extent=EXTENT, device=DEVICE)
    saturated = dataclasses.replace(g, opacity_logit=torch.full_like(
        g.opacity_logit, SATURATED_LOGIT))
    cam = look_at_camera([2.6, 0.0, 1.4], [0, 0, 0.2], [0, 0, 1], fx=96.0,
                         fy=96.0, width=SMALL_W, height=SMALL_H,
                         device=DEVICE)
    rng = np.random.default_rng(1)
    err = {"blend_bwd": 0.0, "preprocess_bwd": 0.0}
    for tile in (16, 32):
        for name, scene in (("", g), (" saturated", saturated)):
            what = f"{SMALL_SPLATS} splats{name} {SMALL_W}x{SMALL_H} tile {tile}"
            e1, r1 = check_preprocess_bwd(P, scene, cam, tile, rng, what)
            e2, r2, zeroed, n_px = check_blend_bwd(P, scene, cam, tile, rng,
                                                   what)
            sync()
            err["preprocess_bwd"] = max(err["preprocess_bwd"], e1)
            err["blend_bwd"] = max(err["blend_bwd"], e2)
            print(f"check {what}: preprocess_bwd max err {e1:.3g} "
                  f"({r1:.3g} of the largest), blend_bwd max err {e2:.3g} "
                  f"({r2:.3g}; all tiles, {zeroed} of {n_px} pixels "
                  "zeroed): ok")
    return err


# ---- training operating point ------------------------------------------------


def train_targets(P, target, cams, cfg):
    """The target's renders, and the perturbed start padded to
    ``CAPACITY`` slots (numpy, seeded)."""
    import dataclasses

    with torch.no_grad():
        images = [P.rasterize(target, c, config=cfg.raster).color for c in cams]
    rng = np.random.default_rng(2)
    noise = torch.from_numpy(
        rng.standard_normal((N_SPLATS, 3)).astype(np.float32)).to(DEVICE)
    start = dataclasses.replace(
        target, sh_dc=target.sh_dc + DC_NOISE * noise,
        opacity_logit=target.opacity_logit + LOGIT_SHIFT).pad_to(CAPACITY)
    return images, start


def camera0_loss(P, losses, g, cam, image, cfg) -> float:
    with torch.no_grad():
        out = P.rasterize(g, cam, bg=torch.zeros(3, device=DEVICE),
                          config=cfg.raster)
        return losses.photometric_loss(out.color, image,
                                       cfg.lambda_dssim).item()


def check_state(state, what: str) -> None:
    import dataclasses

    for name, g in (("gaussians", state.gaussians), ("adam m", state.adam.m),
                    ("adam v", state.adam.v)):
        for f in dataclasses.fields(g):
            x = getattr(g, f.name)
            if x.dtype != torch.bool:
                check(bool(torch.isfinite(x).all()),
                      f"{what}: {name}.{f.name} not finite")


def training_point(P, card: str):
    from autovfx_tpu_torch.train import losses, trainer
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    ops = P.ops
    cams = ring_cameras()
    t0 = time.perf_counter()
    target = make_garden_like(N_SPLATS, seed=0, extent=EXTENT, device=DEVICE)
    worst = max(int(ops.binning.required_budget(
        ops.preprocess_cuda.preprocess(target, c, tile=TILE))) for c in cams)
    # the novel view's sizing, with room for densify to fill the capacity
    budget = ops.binning.round_budget(worst,
                                      slack=BUDGET_SLACK * CAPACITY / N_SPLATS)
    cfg = trainer.TrainConfig(raster=P.RasterConfig(dup_budget=budget,
                                                    tile=TILE),
                              spatial_lr_scale=EXTENT)
    images, start = train_targets(P, target, cams, cfg)
    del target
    print(f"training scene: {N_SPLATS} splats in {CAPACITY} slots, "
          f"duplicates: worst target view {worst}, budget {budget}; made in "
          f"{time.perf_counter() - t0:.1f} s")
    state = trainer.init_state(start)
    loss0 = camera0_loss(P, losses, state.gaussians, cams[0], images[0], cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    # the main path, counted in two runs: the counters are read before,
    # and set to 0 again after, the camera-0 loss between them
    overflow = torch.zeros((), dtype=torch.bool, device=DEVICE)
    step_loss = []
    sync()
    reset_counters(ops)
    for i in range(TRAIN_STEPS):
        state, aux = trainer.train_step(state, cams[i % N_CAMS],
                                        images[i % N_CAMS], cfg)
        overflow |= aux.overflow
        step_loss.append(aux.loss)
    sync()
    launches = counters(ops)
    loss30 = camera0_loss(P, losses, state.gaussians, cams[0], images[0], cfg)
    n_before = int(state.gaussians.num_active)
    sync()
    reset_counters(ops)
    state, res = trainer.densify_step(state, gen, cfg, TRAIN_STEPS)
    state = trainer.reset_opacity_step(state)
    for i in range(AFTER_DENSIFY_STEPS):
        state, aux = trainer.train_step(state, cams[i % N_CAMS],
                                        images[i % N_CAMS], cfg)
        overflow |= aux.overflow
        step_loss.append(aux.loss)
    sync()
    launches = {k: n + launches[k] for k, n in counters(ops).items()}
    steps = TRAIN_STEPS + AFTER_DENSIFY_STEPS
    check_launches(launches, {k: steps for k in (
        "preprocess", "duplicate_with_keys", "blend_fwd_train", "blend_bwd",
        "preprocess_bwd")}, f"{steps} training steps")
    check_state(state, "after training")
    check(not bool(overflow), "training: duplicate budget overflow")
    check(loss30 < loss0, f"camera 0 loss {loss0} -> {loss30} after "
          f"{TRAIN_STEPS} steps")
    n_after = int(state.gaussians.num_active)
    counts = {k: int(getattr(res, k)) for k in ("n_cloned", "n_split",
                                                "n_pruned", "dropped")}
    expect = (n_before + counts["n_cloned"] + 2 * counts["n_split"]
              - counts["n_pruned"] - counts["dropped"])
    check(n_after == expect and n_after <= CAPACITY,
          f"densify: {n_before} -> {n_after} active, counts {counts}")
    losses_ = [x.item() for x in step_loss]
    check(all(np.isfinite(losses_)), "training: a step loss is not finite")
    print(f"training: camera 0 loss {loss0:.5f} -> {loss30:.5f} after "
          f"{TRAIN_STEPS} steps; step losses {losses_[0]:.5f} .. "
          f"{losses_[-1]:.5f}; densify {n_before} -> {n_after} active "
          f"({counts}); launches {launches}")

    # backward kernels at full size against their plain versions
    rng = np.random.default_rng(3)
    g = state.gaussians
    tx, ty = ops.projection.num_tiles(WIDTH, HEIGHT, TILE)
    tiles = torch.from_numpy(rng.choice(tx * ty, CHECK_TILES,
                                        replace=False)).to(DEVICE)
    what = f"{CAPACITY} slots {WIDTH}x{HEIGHT} tile {TILE}"
    e1, r1 = check_preprocess_bwd(P, g, cams[0], TILE, rng, what)
    e2, r2, zeroed, n_px = check_blend_bwd(P, g, cams[0], TILE, rng, what,
                                           tiles=tiles)
    err = {"preprocess_bwd": e1, "blend_bwd": e2}
    sync()
    print(f"checks at {what}: preprocess_bwd on every splat, blend_bwd on "
          f"{CHECK_TILES} tiles ({zeroed} of {n_px} pixels zeroed) against "
          f"the plain versions: ok (max abs err {e1:.3g}, {e2:.3g}; "
          f"{r1:.3g}, {r2:.3g} of the largest)")
    # a step right after the opacity reset, when no pixel freezes early
    after_reset = [cuda_ms(lambda i=i: trainer.train_step(
        state, cams[i % N_CAMS], images[i % N_CAMS], cfg), 1)
        for i in range(AFTER_DENSIFY_STEPS)]
    print(f"[{card}] train step {AFTER_DENSIFY_STEPS + 1}-"
          f"{2 * AFTER_DENSIFY_STEPS} after the opacity reset: median "
          f"{statistics.median(after_reset):.3f} ms")
    del state
    # the timed steps start from the perturbed scene, as a run does
    timed = trainer.init_state(start)
    return launches, err, train_timing(P, card, timed, cams, images, cfg)


def train_timing(P, card, state, cams, images, cfg) -> dict:
    from autovfx_tpu_torch.train import trainer

    ops = P.ops
    box = [state]

    def step(i):
        box[0], _ = trainer.train_step(box[0], cams[i % N_CAMS],
                                       images[i % N_CAMS], cfg)

    for i in range(WARMUP):
        step(i)
    sync()
    torch.cuda.reset_peak_memory_stats()
    step_ms = [cuda_ms(lambda i=i: step(i), 1) for i in range(TRAIN_TIMED)]
    peak = torch.cuda.max_memory_allocated()
    median = statistics.median(step_ms)
    print(f"[{card}] train step {WIDTH}x{HEIGHT} tile {TILE}, {CAPACITY} "
          f"slots: median {median:.3f} ms over {TRAIN_TIMED} steps (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}); "
          f"{1000.0 / median:.2f} it/s; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    run = lambda: [step(i) for i in range(TRAIN_TIMED)]
    streamed = cuda_ms(run, 2) / TRAIN_TIMED
    records = profiled(run, 1)
    busy = sum(e.duration_ns() for e in records) / 1e6 / TRAIN_TIMED
    print(f"[{card}] {TRAIN_TIMED} steps back to back: {streamed:.3f} "
          f"ms/step, device busy {busy:.3f} ms/step, idle share "
          f"{1.0 - busy / streamed:.3f}")
    names = ("preprocess", "binning", "blend_fwd", "loss", "blend_bwd",
             "bwd glue", "preprocess_bwd", "adam+stats")
    stage_ms = dict.fromkeys(names, 0.0)
    opened = TRAIN_STAGES[0][2]  # the records before a step's first kernel
    for e in records:
        own = next((x for x in TRAIN_STAGES if x[0] in e.name()), None)
        if own is None:
            stage_ms[opened] += e.duration_ns() / 1e6 / TRAIN_TIMED
        else:
            stage_ms[own[1]] += e.duration_ns() / 1e6 / TRAIN_TIMED
            opened = own[2]
    print(f"[{card}] train step device time by stage (ms/step over "
          f"{TRAIN_TIMED} steps, profiler): " + ", ".join(
              f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f"; sum {sum(stage_ms.values()):.3f}")

    # each backward kernel beside its plain version, at camera 0's shapes
    cam, g = cams[0], box[0].gaussians
    s = ops.preprocess_cuda.preprocess_kernel(g, cam, tile=TILE)
    b = ops.binning.bin_splats(s, WIDTH, HEIGHT, cfg.raster.dup_budget,
                               tile=TILE)
    _, st = ops.blend_cuda.blend_train_kernel(b, s, WIDTH, HEIGHT, TILE)
    rng = np.random.default_rng(4)
    grads = image_grads(HEIGHT, WIDTH, rng)
    d = splat_grads(P, g.capacity, rng)
    tx, ty = b.num_tiles_x, b.num_tiles_y
    all_tiles = torch.arange(tx * ty, device=DEVICE)
    ms = {}
    ms["blend_bwd"] = in_turns(
        lambda: plain_blend_bwd(P, b, s, grads, TILE, all_tiles),
        lambda: ops.blend_cuda.blend_bwd_kernel(b, s, st, *grads, WIDTH,
                                                HEIGHT, TILE),
        1, "blend_bwd_kernel")
    ms["preprocess_bwd"] = in_turns(
        lambda: ops.preprocess_cuda.preprocess_bwd_plain(
            g, cam, s.tiles_touched, d, tile=TILE),
        lambda: ops.preprocess_cuda.preprocess_bwd_kernel(
            g, cam, s.tiles_touched, d, tile=TILE),
        10, "preprocess_bwd_kernel")
    for k, (k_ms, p_ms) in ms.items():
        print(f"[{card}] {k}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
              f"of device time (x{p_ms / k_ms:.1f})")
    fwd = device_ms(lambda: ops.blend_cuda.blend_train_kernel(
        b, s, WIDTH, HEIGHT, TILE), KERNEL_REPS, "blend_kernel")
    print(f"[{card}] blend_fwd training variant: kernel {fwd:.3f} ms of "
          "device time")
    return ms, fwd


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
    view_launches, err, ms = operating_point(P, card)
    err.update(small_grad_checks(P))
    train_launches, train_err, (train_ms, train_fwd_ms) = training_point(
        P, card)
    for k, e in train_err.items():
        err[k] = max(err.get(k, 0.0), e)
    ms.update(train_ms)
    # each path's own counts; kernel 3 runs its training variant there
    train_launches["blend_fwd"] = train_launches.pop("blend_fwd_train")
    extra = {"blend_fwd": {"training_variant_ms": train_fwd_ms}}
    kernels = []
    for k in KERNELS:
        by_path = {"novel_view": view_launches[k],
                   "training": train_launches[k]}
        kernels.append(dict(
            name=k, route="cuda", **KERNELS[k],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=err[k], ms=ms[k][0], plain_ms=ms[k][1],
            **extra.get(k, {})))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
