#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU: the novel view,
training, the edited frame, its effects, a panorama, an edit program
and a removal program through the port's edit entry, the SuGaR
reconstruction through the port's CLI, the multi-device layer, the
dataset tooling, the from-scratch trainer and the bench.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports ``autovfx_tpu_torch`` from the directory this script lives
in (never JAX, never ``autovfx_tpu``) and

1. checks the machine (a CUDA device, its name and power limit, the
   toolchain), builds the package's CUDA kernels from ``csrc/`` and
   prints each kernel's registers, spills and blocks per SM from the
   build's ``ptxas`` report;
2. holds each kernel against its plain PyTorch version on a 20k-splat
   garden-like scene at 128×96, at tile 16 and tile 32, and kernel 2
   also at its edge cases (``DUPLICATE_CASES``);
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
   profiler), the peak device memory, each backward kernel's device
   time beside its plain version's, and the forward kernels' at the
   training shapes;
7. renders the edited clip of the JAX package's bench.py:344-422 (the
   bench's cube drop simulated on the card, 50,000 surfels, 16 lights,
   the fused frame over the 8 views) with its checks, times and stage
   table;
8. renders the effects clip of bench.py:424-481 on the same scene: a
   96³ smoke/fire volume and the cube's surfels melting, the fire set
   rendered alone and added; checks each frame's kernels on the merged
   set and the fire set against their plain versions, the launch counts
   (from the wrappers and from the profiler), no overflow, the smoke
   and fire in view, no host sync in a frame, a smoke step or a liquid
   substep; and times the smoke step, the melt solve, the frame and its
   stages;
9. runs the effects' small cases (smoke, hash, noise, melt, LPIPS) and
   LaMa at big-lama's widths on the card and on the CPU and holds them
   to each other;
10. renders a panorama of the bench scene at face 512 (six launches of
    each forward kernel, the first face checked against the plain
    versions);
11. runs the port's edit entry, ``edit_scene.run_scene_editing``, on the
    bench scene with a 40,000-splat table, the ring at 1296×840 and an
    offline program (detect the table from its masks, drop a cube on
    it): the original video's render, detect -> extract, the program,
    physics and ``render_scene`` over the 8 views, each stage timed and
    its renders counted, the kernel launches counted over the whole run;
    checks the frames and files, the extracted table and the splat split
    (against a brute-force nearest-triangle split), the cube at rest on
    its top, drawn inside its projected silhouette in the anchor frame,
    well outside it the composite and the shadow ratio against plain
    recomputations, and a background and an object pass's kernels
    against their plain versions; and times a frame;
12. runs a removal program through the same entry on the same scene
    (remove the table, retrieve a basketball from a local asset library,
    drop it where the table stood): LaMa at big-lama's widths (seeded
    weights) on the 8 views' removal renders, the reference's 2,000
    retraining iterations through kernels 1-4 and the preprocess
    backward, the scene reloaded, the ball's 4 previews; checks LaMa's
    outputs and PNGs, the retraining (finite, no overflow, densify's
    counts, the PSNR rising, the backward kernels at one step against
    their plain versions), the scene swap, the table gone from camera
    0's view, the retrieval and a preview's kernels, the ball at rest on
    the patch, and the launches; and times its stages and a frame;
13. runs the port's reconstruction CLI, ``train_gaussians.main``, on a
    COLMAP scene written here (the garden-like scene's 1M centres as the
    SfM points, the ring's 8 views rendered at 1296×840 as PNGs) at the
    reference's SuGaR widths with the step counts cut (``SUGAR_CLI``):
    3DGS, coarse SuGaR (each step's launches counted: kernels 1-4 and
    the preprocess backward once a plain step, twice a regularized
    one), the Poisson extraction, the bound Gaussians, their texture
    and the metrics; then ``refine_train`` on the bound Gaussians and
    the TSDF and density-grid extractions; checks the files, states,
    meshes and the level-set RMS against uniform points; times the
    stages and a regularized step's device operations; and holds a
    plain and a regularized coarse step, the level set and the Poisson
    mesh of the 600-splat shell to the CPU; no render of the CLI, the
    refinement or the side extractions may overflow; kernels 1-3, kernel
    4 and the preprocess backward are held to their plain versions on
    the refined Gaussians at the refinement's budget, on a ring view of
    the coarse Gaussians at the CLI's budget, and (the two backward ones)
    on the inputs a regularized coarse step gives them: kernel 4 with
    the SuGaR terms' depth and alpha cotangents;
14. runs the parallel layer (``autovfx_tpu_torch/parallel``) at the
    training point's state: over one NCCL rank, ``dp_train_step``
    against ``train_step`` and the full-capacity, compact and distributed
    slab renders and the ring as a trajectory against ``rasterize``,
    timed beside them; kernels 1-3 on a slab of four against their plain
    versions, and kernel 4 and the preprocess backward at a DP rank's
    step; then four gloo ranks sharing the card: the DP step over ring
    cameras 0, 2, 4 and 6 against one Adam step on the mean of those
    cameras' gradients, the slab paths against the single render at the
    JAX tests' bounds, the trajectory's builds against the reshard rule,
    each path's launches and each rank's peak memory a path;
15. runs the dataset tooling: the ring written as a COLMAP model, read
    back by ``readers.read_360`` (against the Garden frame recomputed),
    the scene moved into the reader's frame and its 8 depths (and its
    ground disc's alone) rendered, ``normals_from_depth`` on the card
    against the CPU, the gravity found again from the disc's normals
    (RANSAC, ``up_alignment_rotation``, ``normalize_poses``: the aligned
    ring level), ``estimate_scene_scale`` on the edit program's table
    against a plain float64 ray cast, and a 60-frame orbit written,
    reloaded and rendered;
16. runs ``python -m autovfx_tpu_torch.train_at_scale``'s ``main`` at
    300,000 splats, 1296×840 and 24 views for 300 steps: its launches,
    and its final PSNR above its start's;
17. runs the port's bench, ``python -m autovfx_tpu_torch.bench``, in
    every mode at once (``BENCH_MODE=all``) and at the JAX package's
    bench.py defaults, in a subprocess (``bench_point``): its exit, its
    last line's keys (finite, positive), the SuGaR mesh within its vertex
    target and nearer the level than uniform points, and each stage's
    kernel launches; its lines are re-printed here;
18. times the physics substep and the edited clip's replay (last: the
    profiler's sessions after its long one lose records);
19. puts each kernel's time on each path beside its bound (``bound``:
    the least time the card could take, from the bytes and operations
    that path's inputs need, ``*_work``) and their ratio, the share.

Any failed check raises, so the exit code is not 0.  The last three
lines of output, after the run's total seconds, are a JSON object of
the kernels (with each path's own
launch counts, times and bounds), the card's name and power limit as
``nvidia-smi`` prints them, and a JSON object that says the run passed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import struct
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
OPEN_MARKERS = 4  # marker launches that open a first session (spin first)
MARKER_GROWTH = 8  # each retry opens with this many times the markers
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

# edited-frame operating point (the JAX package's bench.py:139-165 and
# :344-422, config 4): the novel view's scene, ring and tile, the cube
# dropped over N_CAMS frames, its surfels, the seed-0 envmap
GROUND_Z = 0.3
CUBE_FACES = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                       [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                       [1, 5, 7], [1, 7, 3]], np.int64)
EDIT_SURFELS = 50_000
SHADOW_SCALE = 2
PHYSICS_SUBSTEPS = 64  # timed in one go
PHYSICS_PROFILED = 8  # substeps in the profiler's session
# the resting cube spans ~200 × 200 pixels of the last ring view; a
# twentieth of that must change for the object to count as drawn
# (checked over the scene's ground disc: see edited_frame_point)
OBJECT_PIXELS_MIN = 2000

# effects-frame operating point (the JAX package's bench.py:424-481): the
# edited frame's scene, ring, drop and surfels with a 96³ smoke/fire
# volume over the clip and the cube's surfels melting
SMOKE_RES = 96
SMOKE_TIMED = 8  # steps timed in one go
# pixels that must differ by > 0.05 from the frame without the volume
EFFECTS_PIXELS_MIN = 10
# the card against the CPU on the effects' small cases, each at the
# tolerance of its CPU test (tests/test_torch_smoke.py, test_torch_liquid,
# test_torch_lpips): fields within FIELD_TOL of their largest on
# FIELD_SHARE of their cells and all within FIELD_MAX_TOL, LPIPS to rtol
PARITY_SMOKE_RES, PARITY_SMOKE_FRAMES, PARITY_MELT_RES = 24, 4, 32
PARITY_ADAPTIVE_CENTER = (11.3, 12.7, 4.0)  # cells, off the shift's ties
PARITY_LPIPS = 128  # image side
FIELD_TOL, FIELD_SHARE, FIELD_MAX_TOL, LPIPS_RTOL = 1e-5, 0.999, 1e-3, 1e-4
# the panorama of the bench scene, from inside its clutter
PANORAMA_FACE = 512
PANORAMA_CENTER = (0.0, 0.0, 0.6)

# the edit program (the port's edit_scene entry over the bench scene): a
# "table" of EDIT_TABLE_SPLATS splats filling a box of TABLE_SIDE x
# TABLE_SIDE x TABLE_TOP m on the ground, its sides along and across
# camera 0's view, its center TABLE_AHEAD m ahead of camera 0, so that its
# near edge lies 0.1 m ahead of the camera's ground point and the whole
# footprint in front of the lens.  The bench scene is opaque ~0.37 m from
# a ring camera (the median depth of camera 0's render), so the table
# stands as near camera 0 as that allows; the clutter still hides its
# top from camera 0, and the cube on it shows.  The DSL lands the cube
# on the centroid of one of the top's two triangles, 0.1 m nearer or
# farther and 0.1 m to the side of the center, 0.2 m from the top's
# edges, so the 0.3 m cube rests wholly on it.  It is dropped
# DROP_OFFSET m above that point: from the DSL's default 0.6 m both
# packages' solvers still hold it 3.8 cm up at the last frame
# (tests/test_torch_edit_table_drop.py).
EDIT_TABLE_SPLATS = 40_000
TABLE_SIDE, TABLE_TOP, TABLE_AHEAD = 0.6, 1.0, 0.4
DROP_OFFSET = 0.3
CUBE_HALF = 0.15  # the 0.3 m cube
TABLE_MARGIN = 0.05  # m: the extracted mesh lies inside the table box
# The split: object_gaussians.ply holds the splats whose nearest
# scene-mesh triangle (among those listed in the point's cell of a
# 32-cell grid over the mesh, as the reference finds it) was extracted.
# Where the true nearest triangle lies within a cell (20 m / 32) of the
# splat, the grid always lists it, so there the split must equal a
# brute-force one but for SPLIT_TIES_MAX splats at a tie.  The clutter
# has no mesh, so the clutter nearest the table's faces joins the table,
# and the table's splats nearest a face that no ring view sees stay out:
# the share of the table in the file (0.60 at full width) and the share
# of the table kept (0.70: the table's volume nearest its top and the
# three sides the ring sees) are held to limits below them.
GRID_CELLS = 32
SPLIT_TIES_MAX = 100
TABLE_SHARE_MIN, TABLE_RECALL_MIN = 0.5, 0.6
# the anchor frame: of the pixels inside the cube's projected silhouette
# (shrunk by SILHOUETTE_INSET px), at least SILHOUETTE_CHANGED_MIN differ
# by > 0.1 from the preamble; the pixels more than SILHOUETTE_OUTSET px
# outside it, at least OUTSIDE_SHARE_MIN of the frame, are the
# background pass darkened by its shadow ratio and nothing else (within
# COMPOSITE_TOL), and where unshadowed (ratio >= 0.99) within PNG_TOL of
# the preamble; the ratio at SHADOW_SAMPLES seeded pixels of them matches
# a plain slab test of the cube's box along each light within
# SHADOW_TOL on at least SHADOW_SHARE_MIN of them (a light grazing an
# edge may fall either way)
SILHOUETTE_INSET, SILHOUETTE_OUTSET = 8, 64  # px at 1296 wide
SILHOUETTE_CHANGED_MIN, OUTSIDE_SHARE_MIN = 0.5, 0.1
PNG_TOL = 1.0 / 255.0 + 1e-6  # the PNGs truncate to 8 bits
COMPOSITE_TOL = 1e-5
SHADOW_SAMPLES, SHADOW_TOL, SHADOW_SHARE_MIN = 4096, 1e-4, 0.995
EDIT_TILE = 16  # RasterConfig's default, which the edit scene renders at

# the removal program (the edit program's scene, the table removed and a
# basketball dropped where it stood): big-lama's published widths
# (configs/training/big-lama.yaml) as seeded weights, which stand in for
# the released ones (not in the repository); the reference's 2,000
# retraining iterations.  The ball's center is dropped BALL_DROP m above
# the table's bottom, so that the once-subdivided icosphere (its hull is
# its mesh) is at rest by the 8th frame: dropped from 0.3 m above the
# table's top it falls 1.3 m and is still moving there.  It is dropped
# BALL_AWAY m beyond the footprint's center, away from camera 0: no ring
# view sees the table's side facing camera 0, so that side stays in the
# removal mesh, and the solver pushes a ball dropped at the center out
# through it (tests/test_torch_removal_drop.py pins all three drops in
# both packages).  At rest the ball sinks below the patch's plane by
# more than the 1 mm collision margin (its lowest vertex 1.6 mm down on
# an H100): BALL_SINK_MAX is the margin, the solver's 1 mm slop and 1 mm
# for the card's physics against the CPU's (tests/test_torch_cuda.py
# holds positions to 1e-3).
LAMA_WIDTHS = dict(ngf=64, n_down=3, n_blocks=18, ratio=0.75)
RETRAIN_ITERATIONS = 2000
RETRAIN_CHECK_STEP = 1000  # the step whose backward kernels are checked
PSNR_STEPS = 50  # steps averaged at each end of the retraining
BALL_SIZE = 0.24  # m, the GPT-4V size table's basketball
BALL_DROP = 0.15
REST_FRAMES = 3  # the last frames over which the ball must not move
BALL_SINK_MAX = 0.003  # m
BALL_AWAY = 0.15  # m
PREVIEW_PIXELS_MIN = 1000
TABLE_GONE_DIFF, TABLE_GONE_SHARE = 0.1, 0.5
# the card against the CPU: LaMa at big-lama's widths on one image
PARITY_LAMA_HW = (96, 128)
LAMA_RANGE_TOL = 1e-4  # of the CPU output's range

# the SuGaR pipeline through the port's reconstruction CLI (BASELINE
# config 3): the reference's widths (1M SfM points in 2M slots, 1M SDF
# samples a step, a 192³ Poisson grid, a 96³ background grid, level 0.3,
# 1M target vertices) at the ring's 1296×840; only the step counts are
# cut: 3DGS 1,000 of 15,000, coarse 40 of 7,000, regularized from 20,
# not 2,000.  The prune at regularize_from keeps opacity >= 0.5, and the
# CLI's Gaussians start at 0.1: on this scene (its far shell hides most
# of the rest from the ring) 14 of 1M pass after 79 steps, ~16,000 after
# 800 on an H100, so 60 3DGS steps would leave nothing to mesh.
SUGAR_ITERATIONS = 1000
SUGAR_REGULARIZE_FROM = 20
SUGAR_CLI = ["--downscale", "1", "--capacity", "2000000", "--iterations",
             str(SUGAR_ITERATIONS), "--coarse_iterations", "40",
             "--regularize_from", str(SUGAR_REGULARIZE_FROM),
             "--mesh_resolution", "192", "--target_vertices", "1000000",
             "--surface_level", "0.3"]
SUGAR_TILE = 16  # the CLI's RasterConfig
SUGAR_TARGET_VERTICES = 1_000_000
SUGAR_SIDE_RES = 96  # the TSDF and density-grid extractions
REFINE_STEPS = 20
TRAIN_LIKE = ("preprocess", "duplicate_with_keys", "blend_fwd_train",
              "blend_bwd", "preprocess_bwd")  # a training pass's launches
RMS_VERTICES = 20_000  # mesh vertices the level-set RMS reads
# the card against the CPU on the 600-splat shell (tests/test_sugar.py)
SHELL_SPLATS, SHELL_SAMPLES, SHELL_POISSON_RES = 600, 4096, 48
SHELL_W, SHELL_H = 64, 48
LEVEL_AGREE, LEVEL_POINT_TOL = 0.995, 1e-4
STATE_TOL = 5e-4  # of each field's largest magnitude, after Adam
LOSS_RTOL = 1e-5

# tolerances of the kernel checks
MEAN2D_ATOL = 1e-4  # px, plus 2 float32 ulps of the coordinate
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6  # conic, color, depth
# Past FLOAT_RTOL a conic row is held to a float64 evaluation instead
# (``conic_against_exact``): within this many float32 ulps times the 2D
# covariance's condition number κ.  Each float32 version came within
# 17.1 of them on the SuGaR refinement's thin splats (κ up to 583, on
# an H100): the kernel, and the plain version on the card alike.
CONIC_KAPPA_ULPS = 32.0
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
        library_ms=None, library_note="no single PyTorch call projects "
        "splats: the plain version is ~60 tensor ops",
    ),
    "duplicate_with_keys": dict(
        source="autovfx_tpu_torch/csrc/duplicate.cu",
        replaces="autovfx_tpu/ops/fill_pallas.py:48",
        library_ms=None, library_note="torch.repeat_interleave gives the "
        "gid column but not the (tile, depth) keys",
    ),
    "blend_fwd": dict(
        source="autovfx_tpu_torch/csrc/blend_fwd.cu",
        replaces="autovfx_tpu/ops/blend_pallas.py:140",
        library_ms=None, library_note="no PyTorch call alpha-blends "
        "depth-sorted splats per tile",
    ),
    "blend_bwd": dict(
        source="autovfx_tpu_torch/csrc/blend_bwd.cu",
        replaces="autovfx_tpu/ops/blend_pallas_bwd.py:62",
        library_ms=None, library_note="no PyTorch call computes the "
        "blend's backward",
    ),
    "preprocess_bwd": dict(
        source="autovfx_tpu_torch/csrc/preprocess_bwd.cu",
        replaces="XLA autodiff of autovfx_tpu/ops/projection.py:74",
        library_ms=None, library_note="no single PyTorch call; the plain "
        "version is autograd of the preprocess",
    ),
}
# the density field's kernels: port-only, no path of the raster's table
FIELD_KERNELS = {
    "density_fwd": dict(
        source="autovfx_tpu_torch/csrc/density_field.cu",
        replaces="none: XLA's fusion of autovfx_tpu/sugar/density.py "
        "compute_density and density_gradient",
        library_ms=None, library_note="no PyTorch call evaluates a "
        "Gaussian mixture over neighbour lists: the twin is ~20 ops a chunk",
    ),
    "density_bwd": dict(
        source="autovfx_tpu_torch/csrc/density_field.cu",
        replaces="none: XLA's autodiff of the same",
        library_ms=None, library_note="no single PyTorch call; the twin is "
        "autograd of the elementwise field",
    ),
}
# threads and dynamic shared memory of each kernel's launch, for its
# blocks per SM (the preprocess backward's at SH degree 3: 15 rest
# coefficients, 70 floats per splat)
LAUNCH_SHAPE = {"preprocess_kernel": (256, 0), "duplicate_kernel": (256, 0),
                "blend_kernel": (256, 0), "blend_bwd_kernel": (256, 0),
                "preprocess_bwd_kernel": (128, 128 * 70 * 4),
                "density_fwd_kernel": (256, 0), "density_bwd_kernel": (256, 0)}
# an H100 SM: registers, shared memory (of it 1 KB reserved per block),
# threads and blocks
SM_REGISTERS, SM_SMEM, SM_THREADS, SM_BLOCKS = 65536, 233472, 2048, 32
# the path each kernel's top-level numbers come from (both where it runs
# on both: the JSON line's "paths")
MAIN_PATH = {"preprocess": "novel_view", "duplicate_with_keys": "novel_view",
             "blend_fwd": "novel_view", "blend_bwd": "training",
             "preprocess_bwd": "training"}

# ---- bounds: the least time the card could take for a kernel's work ---------
#
# The larger of the bytes the function must move (each input read once,
# each output written once) over the memory rate, and its operations over
# the peak rate of their kind: float32 arithmetic, or the special-function
# units' exp and reciprocal, at the SM clock nvidia-smi reads beside the
# timing.  Peaks of an H100 SXM at 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SMS, SFU_PER_SM_CLOCK = 132, 16
# float32 operations (an FMA is 2) per blended (pixel, duplicate) pair,
# counted from the kernels' expressions: the forward's blend of a pair
# (alpha, T, the weight, color and depth), and the backward's (alpha,
# 1 - alpha, f, T, dL/dalpha, S, dL/dpower and the ten gradient terms),
# which also takes a reciprocal on the special-function units.  Only
# blended pairs count: a kernel may cull the others by geometry without
# evaluating them (kernel 4's patch skip does, per warp).
BLEND_FLOPS, BLEND_BWD_FLOPS = 12, 50
# A lower count of the per-splat arithmetic of the preprocess and its
# backward: far below their byte time either way.
PREPROCESS_FLOPS, PREPROCESS_BWD_FLOPS = 200, 400


def bound(n_bytes: float, flops: float = 0.0, sfu_ops: float = 0.0,
          sm_clock_mhz: float = 1980.0) -> dict:
    """``bound_ms``, ``bound_by`` ("bytes" or "operations") and the rate
    that bounds it ("memory", "f32" or "exp") for work that moves
    ``n_bytes`` and does ``flops`` float32 and ``sfu_ops`` special-function
    operations."""
    times = {
        "memory": n_bytes / HBM_BYTES_PER_S * 1e3,
        "f32": flops / F32_FLOPS_PER_S * 1e3,
        "exp": sfu_ops / (SMS * SFU_PER_SM_CLOCK * sm_clock_mhz * 1e6) * 1e3,
    }
    rate = max(times, key=times.get)
    return {"bound_ms": times[rate],
            "bound_by": "bytes" if rate == "memory" else "operations",
            "bound_rate": rate}


def preprocess_work(n: int, k_rest: int) -> tuple[float, float, float]:
    """Kernel 1 over ``n`` slots: (bytes, flops, sfu ops).  A slot reads
    xyz, sh_dc, its SH rest row, log-scales, quaternion, opacity logit
    and active flag, and writes mean2d, conic, opacity, color, depth,
    radius, tile rect and tile count (the camera's 84 bytes once)."""
    read = 4 * (3 + 3 + 3 * k_rest + 3 + 4 + 1) + 1
    write = 4 * (2 + 3 + 1 + 3 + 1 + 1 + 2 + 2 + 1)
    return n * (read + write) + 84, n * PREPROCESS_FLOPS, 0.0


def duplicate_work(n: int, n_live: int, budget: int) -> tuple[float, float,
                                                              float]:
    """Kernel 2: every slot's tile count, a live slot's offset, rect and
    depth, and an int64 key and an int32 gid for every slot of the
    budget: the kernel writes the sentinel slots too."""
    return 4 * n + (8 + 8 + 8 + 4) * n_live + 12 * budget, 0.0, 0.0


def preprocess_bwd_work(n: int, k_rest: int) -> tuple[float, float, float]:
    """The preprocess backward over ``n`` slots: a slot reads its
    parameters, its tile count and 10 output gradients, and writes one
    gradient per parameter (516 bytes at 15 SH rest coefficients)."""
    params = 3 + 3 + 3 * k_rest + 3 + 4 + 1
    return n * 4 * (params + 1 + 10 + params) + 84, n * PREPROCESS_BWD_FLOPS, 0.0


def blend_work(counts: dict, n_live: int, backward: bool = False,
               train: bool = False) -> tuple[float, float, float]:
    """Kernel 3 (``train``: its training variant) or kernel 4 over a view
    whose ``pair_counts`` are ``counts``.  Bytes: each tile's range, the
    gid of every duplicate up to the tile's last contributor, each live
    splat's 10 features (and, for kernel 4, its 10 gradients), and per
    pixel the images written (kernel 3: color, depth, alpha; T and
    n_contrib for training) or read (kernel 4: T, n_contrib and the image
    gradients).  Operations: the blend of each blended pair, its exp and,
    backward, its reciprocal."""
    per_pixel = 28 if backward or train else 20
    n_bytes = (8 * counts["tiles"] + 4 * counts["dups_reached"]
               + 40 * n_live * (2 if backward else 1)
               + per_pixel * counts["pixels"])
    flops = (BLEND_BWD_FLOPS if backward else BLEND_FLOPS) * counts["blended"]
    return n_bytes, flops, (2 if backward else 1) * counts["blended"]


def contrib_counts(n_contrib: torch.Tensor, tile: int) -> dict:
    """From a view's ``BlendState.n_contrib`` (H, W): its pixels, tiles,
    the (pixel, duplicate) pairs up to each pixel's last contributor (the
    sum of n_contrib), the duplicates up to each tile's last one (the
    sum over tiles of their largest n_contrib), and the most pairs of one
    tile (a block's work: the kernels' longest block)."""
    h, w = n_contrib.shape
    tx, ty = (w + tile - 1) // tile, (h + tile - 1) // tile
    full = n_contrib.new_zeros((ty * tile, tx * tile)).long()
    full[:h, :w] = n_contrib
    per_tile = full.reshape(ty, tile, tx, tile).transpose(1, 2).reshape(
        ty * tx, tile * tile)
    return {"pixels": h * w, "tiles": tx * ty,
            "pairs": int(per_tile.sum()),
            "dups_reached": int(per_tile.amax(dim=1).sum()),
            "tile_pairs_max": int(per_tile.sum(dim=1).max())}


def blended_pairs(P, binned, splats, width: int, height: int,
                  tile: int) -> int:
    """The (pixel, duplicate) pairs the blend blends: power <= 0, alpha >=
    1/255 and before the pixel freezes, by the plain blend's own steps
    (``blend_ref``) over batches of tiles, pixels inside the image."""
    n_tiles = binned.tile_range.shape[0]
    total = 0
    for i in range(0, n_tiles, PLAIN_TILE_BATCH):
        tiles = torch.arange(i, min(i + PLAIN_TILE_BATCH, n_tiles),
                             device=binned.gid.device)
        d, live = P.ops.blend_ref.blended_pairs(binned, splats, tile, tiles)
        live &= (d.px < width) & (d.py < height)
        total += int(live.sum())
    return total


def pair_counts(P, binned, splats, n_contrib, width, height, tile) -> dict:
    """``contrib_counts`` of a view and its ``blended`` pairs."""
    counts = contrib_counts(n_contrib, tile)
    counts["blended"] = blended_pairs(P, binned, splats, width, height, tile)
    return counts


def kernel_name(mangled: str) -> str:
    """``blend_kernel<2,1>`` from a kernel's mangled name."""
    m = re.search(r"(preprocess_bwd_kernel|preprocess_kernel|duplicate_kernel"
                  r"|blend_bwd_kernel|blend_kernel|density_fwd_kernel"
                  r"|density_bwd_kernel)(I((?:L[ib]\d+E)+)E)?",
                  mangled)
    if m is None:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(3) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_kernels(log: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, static shared bytes, spill store bytes) of each
    entry function in an ``nvcc -Xptxas=-v`` report."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = kernel_name(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, int(m.group(1)),
                         int(smem.group(1)) if smem else 0, spill))
            name = None
    return rows


def blocks_per_sm(registers: int, smem: int, threads: int) -> int:
    """Blocks of ``threads`` threads that fit on one SM at ``registers``
    a thread (allocated 256 to a warp at a time) and ``smem`` bytes of
    shared memory a block."""
    warps = (threads + 31) // 32
    per_warp = (registers * 32 + 255) // 256 * 256
    by_regs = SM_REGISTERS // per_warp // warps if registers else SM_BLOCKS
    by_smem = SM_SMEM // (smem + 1024) if smem else SM_BLOCKS
    return min(by_regs, by_smem, SM_THREADS // threads, SM_BLOCKS)


def print_ptxas(log: str) -> None:
    for name, regs, smem, spill in ptxas_kernels(log):
        threads, dyn = LAUNCH_SHAPE[name.split("<")[0]]
        print(f"  {name}: {regs} registers, {spill} B spilled, {smem + dyn} B "
              f"shared, {threads} threads: "
              f"{blocks_per_sm(regs, smem + dyn, threads)} blocks per SM")


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reads now (MHz)."""
    return float(run_cmd(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"]).splitlines()[0])


def timed_bound(ms: float, work: tuple, clock: float) -> dict:
    """A kernel's time on one path beside its bound and share."""
    b = bound(*work, sm_clock_mhz=clock)
    return {"ms": ms, **b, "share": b["bound_ms"] / ms, "sm_clock_mhz": clock}


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


def profiled(fn, reps: int, max_lost: int | None = None) -> list:
    """The profiler's device records (kernels, memsets, copies) of
    ``reps`` calls of ``fn``, after one call outside the session.

    The profiler keeps only the device records that fall inside its
    session on the host's clock.  The host's and the card's clocks
    disagree by milliseconds, and by more after a long session, so a
    session can lose records (on an H100, the short sessions after a 2-4 s
    one lost all of theirs, and with idle padding alone, sessions still
    lost their first two records; after a session of ~95,000 launches,
    each short one lost its first seven).  So a session is padded with
    idle time, opens with marker kernels (the first a spin that holds the
    card ~0.25 s) and closes with one, all of which may take such a loss,
    and is taken again, ``SESSION_TRIES`` times at most, each time with
    ``MARKER_GROWTH`` times the opening markers of the last, until the
    launches between the markers whose device record (by correlation id)
    is missing are at most ``MAX_LOST_SHARE`` of them: none in a short
    session (``max_lost``, when given, is the count allowed instead).
    Each missing record is printed with its neighbours."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for attempt in range(SESSION_TRIES):
        markers = OPEN_MARKERS * MARKER_GROWTH**attempt
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            torch.cuda._sleep(OPEN_SPIN_CYCLES)  # markers: spin_kernel
            for _ in range(markers - 1):
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
        n = len(launches) - markers - 1
        lost = [i for i in range(markers, markers + n)
                if launches[i].correlation_id() not in kernel]
        for i in lost[:3]:
            near = [kernel.get(launches[j].correlation_id(), "?")[:60]
                    for j in (i - 1, i + 1)]
            print(f"profiler: no device record for launch "
                  f"{i - markers + 1} of {n} "
                  f"({launches[i].name()}), between {near[0]} and {near[1]}")
        allowed = MAX_LOST_SHARE * n if max_lost is None else max_lost
        if n > 0 and len(lost) <= allowed:
            break
    check(n > 0 and len(lost) <= allowed,
          f"the profiler lost {len(lost)} of {n} kernel records in each of "
          f"{SESSION_TRIES} sessions")
    return sorted((e for e in device if "spin_kernel" not in e.name()),
                  key=lambda e: e.start_ns())


def device_times(fn, reps: int, max_lost: int | None = None
                 ) -> dict[str, float]:
    """Device milliseconds per call of ``fn`` for each name the profiler
    puts on the card."""
    times = {}
    for e in profiled(fn, reps, max_lost):
        ms = e.duration_ns() / 1e6 / reps
        times[e.name()] = times.get(e.name(), 0.0) + ms
    return times


def device_ms(fn, reps: int, kernel: str | None = None,
              max_lost: int | None = None) -> float:
    """Device milliseconds per call of ``fn``: the profiler's sum over
    all it puts on the card, or only over the kernels whose name
    contains ``kernel``."""
    ms = sum(t for name, t in device_times(fn, reps, max_lost).items()
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


def check_preprocess(got, want, what: str, exact=None) -> float:
    """Kernel 1 against the plain preprocess; returns the max abs error
    of the float fields on the splats both call live.  A conic row
    outside the tolerance passes only against ``exact()``, a float64
    evaluation (``conic_against_exact``)."""
    live = (got.tiles_touched > 0) & (want.tiles_touched > 0)
    errs = []

    def agree(f: str, tol) -> None:
        # under the mask of live rows, with no boolean indexing (and so
        # no nonzero): a culled row's fields are never read
        d = (getattr(got, f) - getattr(want, f)).abs()
        rows = live.reshape(-1, *[1] * (d.dim() - 1))
        d_live = torch.where(rows, d, torch.zeros_like(d))
        check(bool(((d <= tol) | ~rows).all()),
              f"{what}: {f} off by {d_live.max().item()}")
        errs.append(d_live.max().item())

    agree("mean2d", MEAN2D_ATOL + 2.0**-22 * want.mean2d.abs())
    for f in ("color", "depth"):
        agree(f, FLOAT_ATOL + FLOAT_RTOL * getattr(want, f).abs())
    d = (got.conic - want.conic).abs()
    off = live & (d > FLOAT_ATOL + FLOAT_RTOL * want.conic.abs()).any(1)
    if bool(off.any()):
        check(exact is not None, f"{what}: conic off by "
              f"{d[off].max().item()} on {int(off.sum())} rows")
        conic_against_exact(got, exact(), off, what)
    errs.append(torch.where(live[:, None], d, torch.zeros_like(d)).max()
                .item())
    d = (got.opacity - want.opacity).abs()
    check(d.max().item() <= OPACITY_ATOL, f"{what}: opacity off by {d.max()}")
    errs.append(d.max().item())
    for f in ("radius", "tile_min", "tile_max", "tiles_touched"):
        d = (getattr(got, f).long() - getattr(want, f).long()).abs()
        d = d.reshape(d.shape[0], -1).amax(dim=1)
        share = (d == 0).double().mean().item()
        check(share >= INT_EXACT_FRACTION, f"{what}: {f} exact on {share}")
        if f != "tiles_touched":  # an area moves by a rect's side
            check(d.max().item() <= 1, f"{what}: {f} off by {d.max()}")
    area = (got.tile_max - got.tile_min).prod(dim=1)
    check(bool((got.tiles_touched == torch.where(got.radius > 0, area, 0))
               .all()), f"{what}: tiles_touched is not the rect area")
    return max(errs)


def preprocess_exact(P, g, cam, tile: int):
    """The plain preprocess in float64: the parameters and the camera
    cast."""
    from autovfx_tpu_torch.core.gaussians import PARAM_FIELDS

    cast = lambda x, names: dataclasses.replace(x, **{
        n: torch.as_tensor(getattr(x, n)).double() for n in names})
    return P.ops.projection.preprocess(
        cast(g, PARAM_FIELDS), cast(cam, ("R", "t", "fx", "fy", "cx", "cy")),
        tile=tile)


def conic_against_exact(got, exact, rows, what) -> None:
    """Kernel 1's conic on ``rows`` within ``CONIC_KAPPA_ULPS`` float32
    ulps, times the 2D covariance's condition number κ, of the row's
    largest entry of the float64 evaluation ``exact``.  Any float32
    det = ac - b² loses κ-fold relative precision, so where κ is large
    (thin splats seen edge-on) two float32 evaluations differ by more
    than ``FLOAT_RTOL``; the plain version is then as far from float64
    as the kernel."""
    q = exact.conic[rows]
    a, b, c = q.unbind(-1)
    mid, rad = (a + c) / 2, torch.sqrt(((a - c) / 2) ** 2 + b * b)
    kappa = (mid + rad) / torch.clamp(mid - rad, min=1e-300)
    ulps = ((got.conic[rows].double() - q).abs().amax(1)
            / (2.0**-24 * kappa * q.abs().amax(1)))
    check(bool((ulps <= CONIC_KAPPA_ULPS).all()),
          f"{what}: conic {ulps.max().item():.3g} κ-ulps from float64 on "
          f"{int(rows.sum())} ill-conditioned rows (κ up to "
          f"{kappa.max().item():.3g})")
    print(f"{what}: {int(rows.sum())} rows of conditioning κ "
          f"{kappa.min().item():.3g}-{kappa.max().item():.3g} outside the "
          f"conic's tolerance of the plain version, within "
          f"{ulps.max().item():.3g} κ-ulps of float64")


def check_duplicates(P, splats, tiles_x, n_tiles, budget, what) -> float:
    """Kernel 2 against its repeat_interleave version on a view's
    splats."""
    counts = splats.tiles_touched
    starts = torch.cumsum(counts, 0) - counts
    return check_duplicate_args(
        P, (counts, starts, splats.tile_min, splats.tile_max, splats.depth,
            tiles_x, n_tiles, budget), what)


# kernel 2's edge cases (``duplicate_case``)
DUPLICATE_CASES = ("zero counts and a sentinel tail",
                   "one Gaussian over every tile", "a budget cut mid-rect",
                   "every Gaussian culled", "no Gaussians")


def duplicate_case(name: str, device) -> tuple:
    """The ``duplicate_with_keys`` arguments of one of ``DUPLICATE_CASES``
    on a 41 x 27 tile grid (numpy, seeded): runs of culled Gaussians
    (with rects that must not be read) across the kernel's blocks of
    256, one Gaussian whose rect is the whole grid, the budget ending in
    the middle of that rect, all culled, and none."""
    rng = np.random.default_rng(DUPLICATE_CASES.index(name))
    tiles_x, tiles_y = 41, 27
    n = 0 if name == "no Gaussians" else 1000
    x0 = rng.integers(0, tiles_x, n)
    y0 = rng.integers(0, tiles_y, n)
    x1 = np.minimum(x0 + rng.integers(1, 5, n), tiles_x)
    y1 = np.minimum(y0 + rng.integers(1, 4, n), tiles_y)
    live = rng.random(n) > 0.4
    live[250:262] = live[500:530] = False  # across blocks' edges
    big = 300  # the Gaussian over every tile
    if n:
        x0[big], y0[big], x1[big], y1[big] = 0, 0, tiles_x, tiles_y
        live[big] = True
    if name == "every Gaussian culled":
        live[:] = False
    area = np.where(live, (x1 - x0) * (y1 - y0), 0)
    dev = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=device)
    counts = dev(area, torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    total = int(area.sum())
    budget = {"zero counts and a sentinel tail": total + 777,
              "one Gaussian over every tile": total,
              "a budget cut mid-rect": int(area[:big].sum()) + 500,
              }.get(name, 3000)
    return (counts, starts, dev(np.stack([x0, y0], 1), torch.int32),
            dev(np.stack([x1, y1], 1), torch.int32),
            dev(rng.uniform(0.3, 9.0, n), torch.float32), tiles_x,
            tiles_x * tiles_y, budget)


def check_duplicate_args(P, args, what) -> float:
    """Kernel 2 against its repeat_interleave version on ``args``, bit for
    bit, raw and sorted."""
    k_keys, k_gids = P.ops.fill_cuda.duplicate_with_keys_kernel(*args)
    p_keys, p_gids = P.ops.fill_cuda.duplicate_with_keys_plain(*args)
    check(torch.equal(k_keys, p_keys) and torch.equal(k_gids, p_gids),
          f"{what}: duplicate keys/gids differ")
    ks, kg = P.ops.binning.sort_duplicates(k_keys, k_gids)
    ps, pg = P.ops.binning.sort_duplicates(p_keys, p_gids)
    check(torch.equal(ks >> 32, ps >> 32) and torch.equal(kg, pg),
          f"{what}: sorted (tile, gid) differ")
    if k_keys.numel() == 0:
        return 0.0
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


def check_view_kernels(P, g, cam, budget, tile, rng, what) -> dict:
    """Kernels 1-3 on one view of ``g`` against their plain versions (the
    blend on ``CHECK_TILES`` seeded tiles); each one's largest error."""
    ops = P.ops
    w, h = cam.width, cam.height
    tx, ty = ops.projection.num_tiles(w, h, tile)
    s = ops.preprocess_cuda.preprocess_kernel(g, cam, tile=tile)
    err = {"preprocess": check_preprocess(
        s, ops.projection.preprocess(g, cam, tile=tile), what,
        exact=lambda: preprocess_exact(P, g, cam, tile))}
    err["duplicate_with_keys"] = check_duplicates(P, s, tx, tx * ty, budget,
                                                  what)
    b = ops.binning.bin_splats(s, w, h, budget, tile=tile)
    check(not bool(b.overflow), f"{what}: overflow")
    images = ops.blend_cuda.blend_kernel(b, s, w, h, tile)
    tiles = torch.from_numpy(rng.choice(tx * ty, CHECK_TILES,
                                        replace=False)).to(DEVICE)
    err["blend_fwd"] = check_blend(P, b, s, images, tiles, w, h, tile, what)
    sync()
    return err


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
    for name in DUPLICATE_CASES:
        check_duplicate_args(P, duplicate_case(name, DEVICE), name)
    sync()
    print(f"check duplicates at {len(DUPLICATE_CASES)} edge cases "
          f"({', '.join(DUPLICATE_CASES)}): bit-equal: ok")


# ---- operating point ---------------------------------------------------------


def load_scene():
    from autovfx_tpu_torch.core import ply_io
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    t0 = time.perf_counter()
    g = make_garden_like(N_SPLATS, seed=0, extent=EXTENT, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "garden_like.ply")
        ply_io.save_ply(path, g)
        size = os.path.getsize(path)
        g = ply_io.load_ply(path, device=DEVICE)
    print(f"scene: {g.capacity} splats through a {size / 2**20:.1f} MiB PLY "
          f"in {time.perf_counter() - t0:.1f} s")
    return g


def check_launches(launches: dict, want: dict, what: str) -> None:
    """Each wrapper launched exactly as often as the path should."""
    for name, n in launches.items():
        check(n == want.get(name, 0),
              f"{what}: {name} launched {n} times, not {want.get(name, 0)}")


def operating_point(P, card: str) -> list[dict]:
    from autovfx_tpu_torch import bench

    ops = P.ops
    g = load_scene()
    cams = bench.ring_cameras(WIDTH, HEIGHT, N_CAMS, DEVICE)
    worst = max(int(ops.binning.required_budget(
        ops.preprocess_cuda.preprocess(g, c, tile=TILE))) for c in cams)
    budget = ops.binning.round_budget(worst, slack=BUDGET_SLACK)
    config = P.RasterConfig(dup_budget=budget, tile=TILE)
    bg = torch.zeros(3, device=DEVICE)
    print(f"duplicates: worst view {worst}, budget {budget}")

    # the main path, counted
    sync()
    P.utils.trace.reset()
    frames = [P.rasterize(g, c, bg=bg, config=config) for c in cams]
    sync()
    launches = bench.kernel_launches()
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
    ms, clock = {}, {}
    ms["preprocess"] = in_turns(
        lambda: ops.projection.preprocess(g, cam, tile=TILE),
        lambda: ops.preprocess_cuda.preprocess_kernel(g, cam, tile=TILE),
        10, "preprocess_kernel")
    clock["preprocess"] = sm_clock_mhz()
    ms["duplicate_with_keys"] = in_turns(
        lambda: ops.fill_cuda.duplicate_with_keys_plain(*dup_args),
        lambda: ops.fill_cuda.duplicate_with_keys_kernel(*dup_args),
        10, "duplicate_kernel")
    clock["duplicate_with_keys"] = sm_clock_mhz()
    ms["blend_fwd"] = in_turns(
        lambda: blend_subset(P, b, s, all_tiles, TILE),
        lambda: ops.blend_cuda.blend_kernel(b, s, WIDTH, HEIGHT, TILE),
        2, "blend_kernel")
    clock["blend_fwd"] = sm_clock_mhz()
    for k, (k_ms, p_ms) in ms.items():
        print(f"[{card}] {k}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
              f"of device time (x{p_ms / k_ms:.1f})")

    # their bounds at these shapes
    n_live = int((s.tiles_touched > 0).sum())
    _, st = ops.blend_cuda.blend_train_kernel(b, s, WIDTH, HEIGHT, TILE)
    pairs = pair_counts(P, b, s, st.n_contrib, WIDTH, HEIGHT, TILE)
    work = {
        "preprocess": preprocess_work(g.capacity, g.sh_rest.shape[1]),
        "duplicate_with_keys": duplicate_work(g.capacity, n_live, budget),
        "blend_fwd": blend_work(pairs, n_live),
    }
    perf = {k: {"novel_view": timed_bound(ms[k][0], work[k], clock[k])}
            for k in work}
    print(f"[{card}] first view: {n_live} live splats, {pairs}")
    print_bounds(card, perf, "novel_view")
    return launches, err, ms, perf


def print_bounds(card: str, perf: dict, path: str) -> None:
    for k, by_path in perf.items():
        if path in by_path:
            x = by_path[path]
            print(f"[{card}] {k} on {path}: {x['ms']:.4f} ms, bound "
                  f"{x['bound_ms']:.4f} ms by the {x['bound_rate']} rate "
                  f"(SM clock {x['sm_clock_mhz']:.0f} MHz), share "
                  f"{x['share']:.3f}")


# ---- backward kernels --------------------------------------------------------


def check_fields(got, want, tol: float, what: str) -> tuple[float, float]:
    """Per field of two gradient NamedTuples: max |got - want| over the
    largest |want| must stay below ``tol``; returns the max abs error and
    the largest such ratio."""
    worst, rel = 0.0, 0.0
    for name, a, b in zip(want._fields, got, want):
        if b is None or b.numel() == 0:  # no such gradient, or no SH rest
            continue
        check(bool(torch.isfinite(a).all()), f"{what}: d {name} not finite")
        d = (a.double() - b.double()).abs().max().item()
        scale = b.abs().max().item() + 1e-12
        check(d / scale <= tol, f"{what}: d {name} off by {d:.3g} "
              f"({d / scale:.3g} of its largest {scale:.3g})")
        worst, rel = max(worst, d), max(rel, d / scale)
    return worst, rel


def splat_grads(P, n: int, rng) -> object:
    """Random output gradients of the preprocess on the card: column
    slices of one (N, 10) f32 buffer, as kernel 4 hands them over."""
    rows = torch.from_numpy(
        rng.standard_normal((n, 10)).astype(np.float32)).to(DEVICE)
    return P.ops.blend_ref.SplatGrads(mean2d=rows[:, 0:2],
                                      conic=rows[:, 2:5], opacity=rows[:, 5],
                                      color=rows[:, 6:9], depth=rows[:, 9])


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
    s = ops.preprocess_cuda.preprocess_kernel(g, cam, tile=tile)
    budget = ops.binning.round_budget(int(ops.binning.required_budget(s)))
    b = ops.binning.bin_splats(s, cam.width, cam.height, budget, tile=tile)
    return check_blend_bwd_binned(P, b, s, cam.width, cam.height, tile, rng,
                                  what, tiles)


def check_blend_bwd_binned(P, b, s, w, h, tile, rng, what, tiles=None,
                           grads=None):
    """``check_blend_bwd`` on a binned view ``b`` of splats ``s``; with
    ``grads`` (the color, depth and alpha images' cotangents, zeroed as
    the random ones are) in place of random ones."""
    ops = P.ops
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
    if grads is None:
        grads = image_grads(h, w, rng, keep)
    else:
        grads = [(grads[0] * keep[..., None]).contiguous(),
                 (grads[1] * keep).contiguous(), (grads[2] * keep).contiguous()]
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


def training_setup(P):
    """The training point: the ring, the target scene, the config (the
    novel view's budget sizing, with room for densify to fill the
    capacity), the target's renders and the perturbed start."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.train import trainer
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    ops = P.ops
    cams = bench.ring_cameras(WIDTH, HEIGHT, N_CAMS, DEVICE)
    t0 = time.perf_counter()
    target = make_garden_like(N_SPLATS, seed=0, extent=EXTENT, device=DEVICE)
    worst = max(int(ops.binning.required_budget(
        ops.preprocess_cuda.preprocess(target, c, tile=TILE))) for c in cams)
    budget = ops.binning.round_budget(worst,
                                      slack=BUDGET_SLACK * CAPACITY / N_SPLATS)
    cfg = trainer.TrainConfig(raster=P.RasterConfig(dup_budget=budget,
                                                    tile=TILE),
                              spatial_lr_scale=EXTENT)
    images, start = train_targets(P, target, cams, cfg)
    print(f"training scene: {N_SPLATS} splats in {CAPACITY} slots, "
          f"duplicates: worst target view {worst}, budget {budget}; made in "
          f"{time.perf_counter() - t0:.1f} s")
    return cams, target, cfg, images, start


def training_point(P, card: str):
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.train import losses, trainer

    ops = P.ops
    cams, target, cfg, images, start = training_setup(P)
    del target
    state = trainer.init_state(start)
    loss0 = camera0_loss(P, losses, state.gaussians, cams[0], images[0], cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    # the main path, counted in two runs: the counters are read before,
    # and set to 0 again after, the camera-0 loss between them
    overflow = torch.zeros((), dtype=torch.bool, device=DEVICE)
    step_loss = []
    sync()
    P.utils.trace.reset()
    for i in range(TRAIN_STEPS):
        state, aux = trainer.train_step(state, cams[i % N_CAMS],
                                        images[i % N_CAMS], cfg)
        overflow |= aux.overflow
        step_loss.append(aux.loss)
    sync()
    launches = bench.kernel_launches()
    loss30 = camera0_loss(P, losses, state.gaussians, cams[0], images[0], cfg)
    n_before = int(state.gaussians.num_active)
    sync()
    P.utils.trace.reset()
    state, res = trainer.densify_step(state, gen, cfg, TRAIN_STEPS)
    state = trainer.reset_opacity_step(state)
    for i in range(AFTER_DENSIFY_STEPS):
        state, aux = trainer.train_step(state, cams[i % N_CAMS],
                                        images[i % N_CAMS], cfg)
        overflow |= aux.overflow
        step_loss.append(aux.loss)
    sync()
    launches = {k: n + launches[k] for k, n in bench.kernel_launches().items()}
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


def train_timing(P, card, state, cams, images, cfg) -> tuple[dict, dict]:
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
    ms, clock = {}, {}
    ms["blend_bwd"] = in_turns(
        lambda: plain_blend_bwd(P, b, s, grads, TILE, all_tiles),
        lambda: ops.blend_cuda.blend_bwd_kernel(b, s, st, *grads, WIDTH,
                                                HEIGHT, TILE),
        1, "blend_bwd_kernel")
    clock["blend_bwd"] = sm_clock_mhz()
    ms["preprocess_bwd"] = in_turns(
        lambda: ops.preprocess_cuda.preprocess_bwd_plain(
            g, cam, s.tiles_touched, d, tile=TILE),
        lambda: ops.preprocess_cuda.preprocess_bwd_kernel(
            g, cam, s.tiles_touched, d, tile=TILE),
        10, "preprocess_bwd_kernel")
    clock["preprocess_bwd"] = sm_clock_mhz()
    for k, (k_ms, p_ms) in ms.items():
        print(f"[{card}] {k}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
              f"of device time (x{p_ms / k_ms:.1f})")

    # the forward kernels at the training step's shapes
    counts = s.tiles_touched
    starts = torch.cumsum(counts, 0) - counts
    dup_args = (counts, starts, s.tile_min, s.tile_max, s.depth, tx, tx * ty,
                cfg.raster.dup_budget)
    fwd_ms = {
        "preprocess": device_ms(lambda: ops.preprocess_cuda.preprocess_kernel(
            g, cam, tile=TILE), KERNEL_REPS, "preprocess_kernel"),
        "duplicate_with_keys": device_ms(
            lambda: ops.fill_cuda.duplicate_with_keys_kernel(*dup_args),
            KERNEL_REPS, "duplicate_kernel"),
        "blend_fwd": device_ms(lambda: ops.blend_cuda.blend_train_kernel(
            b, s, WIDTH, HEIGHT, TILE), KERNEL_REPS, "blend_kernel"),
    }
    fwd_clock = sm_clock_mhz()
    print(f"[{card}] forward kernels at the training shapes: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in fwd_ms.items())
        + " of device time (kernel 3 as its training variant)")

    # every kernel's bound at camera 0's shapes
    k_rest = g.sh_rest.shape[1]
    n_live = int((counts > 0).sum())
    pairs = pair_counts(P, b, s, st.n_contrib, WIDTH, HEIGHT, TILE)
    work = {
        "preprocess": preprocess_work(g.capacity, k_rest),
        "duplicate_with_keys": duplicate_work(g.capacity, n_live,
                                              cfg.raster.dup_budget),
        "blend_fwd": blend_work(pairs, n_live, train=True),
        "blend_bwd": blend_work(pairs, n_live, backward=True),
        "preprocess_bwd": preprocess_bwd_work(g.capacity, k_rest),
    }
    times = {**fwd_ms, **{k: v[0] for k, v in ms.items()}}
    perf = {k: {"training": timed_bound(times[k], work[k],
                                        clock.get(k, fwd_clock))}
            for k in work}
    print(f"[{card}] camera 0 of the training state: {n_live} live splats, "
          f"{pairs}")
    print_bounds(card, perf, "training")
    return ms, perf


# ---- edited-frame operating point --------------------------------------------


def no_syncs(fn, what: str) -> None:
    """Run ``fn`` with PyTorch's sync debug mode on; fail if any of its
    operations waited on the card (a copy to the host, ``.item()``, a
    ``nonzero``...)."""
    import warnings

    sync()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(x.message) for x in caught if "synchroniz" in str(x.message)]
    check(not syncs, f"{what} waits on the card: {syncs[:3]}")


def ground_disc(g):
    """The ground disc of ``make_garden_like``'s scene: its first half of
    rows (then come the clutter and the far shell)."""
    n = g.capacity // 2
    return dataclasses.replace(g, **{f.name: getattr(g, f.name)[:n]
                                     for f in dataclasses.fields(g)})


def edit_inputs(P, g, cams):
    """The drop simulated on the card, then the clip's inputs: 50,000
    surfels of the cube, the seed-0 32×64 envmap, 16 lights; and a
    function that builds them again with effects keywords
    (``smoke_traj``, ``melt``)."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.physics import world

    w, corners = bench.cube_world(DEVICE)
    _, pos, quat = world.simulate(w, N_CAMS)
    _, pos2, quat2 = world.simulate(w, N_CAMS)
    check(np.array_equal(pos, pos2) and np.array_equal(quat, quat2),
          "two simulate runs on the card differ")
    z = pos[:, 0, 2]  # the COM's height; the cube rests at ground + 0.3
    check(z[-1] < z[0] - 0.5, f"the cube did not fall: z {z}")
    check(z.min() > GROUND_Z + 0.3 - w.cfg.collision_margin,
          f"the cube went through the ground: z {z}")
    traj = world.origin_trajectory(w, pos, quat)
    surf = bench.cube_surfels(corners, EDIT_SURFELS, DEVICE)

    def build(**effects):
        return bench.clip_inputs(g, cams, w, surf, traj, DEVICE, **effects)

    inp = build()
    print(f"edit: the cube's COM z over {N_CAMS} frames "
          + ", ".join(f"{x:.3f}" for x in z) + f"; {EDIT_SURFELS} surfels, "
          f"{inp.light_dirs.shape[0]} lights after deduplication, "
          f"{inp.hull_planes.shape[1]} hull planes; two simulate runs "
          "bit-equal: ok")
    return w, inp, build


def edit_stages(P, inp, i, config):
    """The fused frame's stages on frame ``i``, as functions of nothing,
    each from the outputs of the stages before it (made once here)."""
    from autovfx_tpu_torch.core.cameras import index_camera
    from autovfx_tpu_torch.ops import binning, blend_cuda, preprocess_cuda
    from autovfx_tpu_torch.ops.projection import Splats2D, empty_splats
    from autovfx_tpu_torch.ops.rasterize import RenderOutput
    from autovfx_tpu_torch.render import clip, shadow

    cam = index_camera(inp.cams, i)
    n_bg = inp.bg.capacity
    n = n_bg + inp.surf_points.shape[0]
    buf = empty_splats(n, DEVICE)
    rows = lambda lo, hi: Splats2D(*(x[lo:hi] for x in buf))
    pre = lambda g, out: preprocess_cuda.preprocess(g, cam, tile=TILE,
                                                    out=out)
    g_obj = clip.shaded_object_gaussians(inp, i, cam)
    pre(inp.bg, rows(0, n_bg))
    pre(g_obj, rows(n_bg, n))
    binned = binning.bin_splats(buf, cam.width, cam.height,
                                config.dup_budget, tile=TILE)
    color, depth, alpha = blend_cuda.blend(binned, buf, cam.width,
                                           cam.height, TILE)
    out = RenderOutput(color, depth, alpha, buf.radius, binned.overflow)
    a = alpha.clamp(0.0, 1.0)
    planes = clip.world_hull_planes_at(inp, i)
    scene_depth = clip.pass_depth(out, a)
    w_obj = shadow.hull_object_weight(cam, scene_depth, planes, inp.hull_mask,
                                      pad=clip.object_pad(inp))
    ratio = shadow.shadow_ratio_map(
        cam, depth, a.clamp(min=1e-3), inp.light_dirs, inp.light_weights,
        planes, inp.hull_mask, scale=SHADOW_SCALE)
    bg_part, obj_part = rows(0, n_bg), rows(n_bg, n)
    stages = {
        "background preprocess": lambda: pre(inp.bg, bg_part),
        "object shading + preprocess": lambda: pre(
            clip.shaded_object_gaussians(inp, i, cam), obj_part),
        "binning": lambda: binning.bin_splats(buf, cam.width, cam.height,
                                              config.dup_budget, tile=TILE),
        "blend": lambda: blend_cuda.blend(binned, buf, cam.width, cam.height,
                                          TILE),
        "hull weight": lambda: shadow.hull_object_weight(
            cam, clip.pass_depth(out, a), clip.world_hull_planes_at(inp, i),
            inp.hull_mask, pad=clip.object_pad(inp)),
        "shadow ratio": lambda: shadow.shadow_ratio_map(
            cam, depth, a.clamp(min=1e-3), inp.light_dirs, inp.light_weights,
            planes, inp.hull_mask, scale=SHADOW_SCALE),
        "composite": lambda: clip.fused_composite(out, ratio, w_obj),
    }
    parts = (preprocess_cuda.preprocess(inp.bg, cam, tile=TILE),
             preprocess_cuda.preprocess(g_obj, cam, tile=TILE))
    join_by_cat = lambda: Splats2D(*(torch.cat(x) for x in zip(*parts)))
    return dict(cam=cam, g_obj=g_obj, splats=buf, binned=binned,
                images=(color, depth, alpha), ratio=ratio, w_obj=w_obj,
                stages=stages, join_by_cat=join_by_cat)


def edited_frame_point(P, card: str) -> tuple[dict, dict, dict, dict]:
    """The edited frame at the operating point of the JAX package's
    bench.py:344-422 (config 4), through ``render_clip(fused=True)``."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.ops.rasterize import preprocess_sets
    from autovfx_tpu_torch.physics import solver
    from autovfx_tpu_torch.render import clip
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    ops = P.ops
    cams = bench.ring_cameras(WIDTH, HEIGHT, N_CAMS, DEVICE)
    g = make_garden_like(N_SPLATS, seed=0, extent=EXTENT, device=DEVICE)
    w, inp, build = edit_inputs(P, g, cams)
    worst = 0
    for i, cam in enumerate(cams):
        g_obj = clip.shaded_object_gaussians(inp, i, cam)
        s = preprocess_sets([g, g_obj], cam, P.RasterConfig(tile=TILE))
        worst = max(worst, int(ops.binning.required_budget(s)))
    budget = ops.binning.round_budget(worst, slack=BUDGET_SLACK)
    config = P.RasterConfig(dup_budget=budget, tile=TILE)
    print(f"edit duplicates: worst merged view {worst}, budget {budget}")

    # the main path, counted
    sync()
    P.utils.trace.reset()
    frames = clip.render_clip(inp, N_CAMS, config, fused=True)
    sync()
    launches = bench.kernel_launches()
    check_launches(launches, {"preprocess": 2 * N_CAMS,
                              "duplicate_with_keys": N_CAMS,
                              "blend_fwd": N_CAMS}, f"{N_CAMS} edited frames")
    check(frames.shape == (N_CAMS, HEIGHT, WIDTH, 3), "edited frames: shape")
    check(bool(torch.isfinite(frames).all()), "edited frames: not finite")
    check(frames.min().item() >= 0.0 and frames.max().item() <= 1.0,
          "edited frames: outside [0, 1]")

    # each frame's kernels against their plain versions, and its binning
    tx, ty = ops.projection.num_tiles(WIDTH, HEIGHT, TILE)
    rng = np.random.default_rng(5)
    err = {}
    for i in range(N_CAMS):
        st = edit_stages(P, inp, i, config)
        what = f"edited frame {i}"
        check(not bool(st["binned"].overflow),
              f"{what}: duplicate budget overflow")
        if i == N_CAMS - 1:  # the cube at rest, in view
            err["preprocess"] = check_preprocess(
                ops.preprocess_cuda.preprocess_kernel(st["g_obj"], st["cam"],
                                                      tile=TILE),
                ops.projection.preprocess(st["g_obj"], st["cam"], tile=TILE),
                f"{what} surfels")
            err["duplicate_with_keys"] = check_duplicates(
                P, st["splats"], tx, tx * ty, budget, f"{what} merged")
        tiles = torch.from_numpy(
            rng.choice(tx * ty, CHECK_TILES, replace=False)).to(DEVICE)
        err["blend_fwd"] = max(err.get("blend_fwd", 0.0), check_blend(
            P, st["binned"], st["splats"], st["images"], tiles, WIDTH, HEIGHT,
            TILE, what))
        sync()

    # the object in view and its shadow, on the last frame.  At the
    # bench point the cube lands inside the scene's clutter (mean alpha
    # 1 in every view), so these are checked on the same clip over the
    # scene's ground disc alone, where nothing stands in front of it
    last = N_CAMS - 1
    bg_only = P.rasterize(g, cams[last], config=config).color.clamp(0, 1)
    hidden = int(((frames[last] - bg_only).abs().amax(-1) > 0.1).sum())
    ground = ground_disc(g)
    inp_open = dataclasses.replace(inp, bg=ground)
    st = edit_stages(P, inp_open, last, config)
    check(not bool(st["binned"].overflow), "ground-disc frame: overflow")
    open_frame = clip.render_edited_frame_fused(inp_open, last, config,
                                                shadow_scale=SHADOW_SCALE)
    open_bg = P.rasterize(ground, cams[last], config=config).color.clamp(0, 1)
    changed = int(((open_frame - open_bg).abs().amax(-1) > 0.1).sum())
    shadowed = int(((st["ratio"] < 0.99) & (st["w_obj"] == 0)).sum())
    check(bool(torch.isfinite(open_frame).all()), "ground-disc frame: finite")
    check(changed > OBJECT_PIXELS_MIN,
          f"ground-disc frame {last}: {changed} pixels differ from the "
          f"background by > 0.1 (at least {OBJECT_PIXELS_MIN} wanted)")
    check(shadowed > 0,
          f"ground-disc frame {last}: no shadowed background pixel")
    print(f"edited frames: {launches}; the last frame: {hidden} pixels "
          f"differ from the background-only frame by > 0.1 (the cube rests "
          f"inside the clutter); over the ground disc alone "
          f"({ground.capacity} splats): {changed} pixels differ by > 0.1, "
          f"{shadowed} background pixels shadowed (ratio < 0.99, object "
          f"weight 0); checks at {N_SPLATS} + {EDIT_SURFELS} splats "
          f"{WIDTH}x{HEIGHT} tile {TILE}: kernel 1 on the surfels, kernel 2 "
          f"on the merged set, kernel 3 on {CHECK_TILES} tiles/frame against "
          "the plain versions: ok")
    del ground, inp_open, st, open_frame, open_bg
    st = edit_stages(P, inp, last, config)

    # times
    def frame(i):
        return clip.render_edited_frame_fused(inp, i % N_CAMS, config,
                                              shadow_scale=SHADOW_SCALE)

    for i in range(WARMUP):
        frame(i)
    no_syncs(lambda: frame(0), "the fused edited frame")
    no_syncs(lambda: solver.substep(w.shape, w.state, w.params, w.grid, w.cfg),
             "a physics substep")
    print("the fused edited frame and a physics substep read nothing back "
          "from the card (sync debug mode): ok")
    torch.cuda.reset_peak_memory_stats()
    frame_ms = [cuda_ms(lambda i=i: frame(i), 1) for i in range(TIMED)]
    peak = torch.cuda.max_memory_allocated()
    median = statistics.median(frame_ms)
    print(f"[{card}] edited frame {WIDTH}x{HEIGHT} tile {TILE}, {N_SPLATS} + "
          f"{EDIT_SURFELS} splats, {inp.light_dirs.shape[0]} lights, shadow "
          f"scale {SHADOW_SCALE}: median {median:.3f} ms over {TIMED} frames "
          f"(min {min(frame_ms):.3f}, max {max(frame_ms):.3f}); "
          f"{1000.0 / median:.1f} frames/s; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    run = lambda: [frame(i) for i in range(TIMED)]
    streamed = cuda_ms(run, 3) / TIMED
    records = profiled(run, 1)
    busy = sum(e.duration_ns() for e in records) / 1e6 / TIMED
    print(f"[{card}] {TIMED} edited frames back to back: {streamed:.3f} "
          f"ms/frame, device busy {busy:.3f} ms/frame, idle share "
          f"{1.0 - busy / streamed:.3f}; {len(records) / TIMED:.0f} device "
          "records (kernels, copies) a frame")

    # a stage of small kernels may lose its session's first record (the
    # profiler's clock; see ``profiled``): one is allowed, a few
    # microseconds of ~10 calls' milliseconds
    stage_ms = {k: device_ms(fn, KERNEL_REPS, max_lost=1)
                for k, fn in st["stages"].items()}
    cat_ms = device_ms(st["join_by_cat"], KERNEL_REPS, max_lost=1)
    print(f"[{card}] edited frame device time by stage (ms, profiler, last "
          "frame): " + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f"; sum {sum(stage_ms.values()):.3f}; join: none (kernel 1 "
          f"writes each set's rows of one buffer; a torch.cat of the two "
          f"sets' splats would take {cat_ms:.3f})")

    # kernels 1-3 on the last frame's shapes
    cam, g_obj, s, b = st["cam"], st["g_obj"], st["splats"], st["binned"]
    counts = s.tiles_touched
    starts = torch.cumsum(counts, 0) - counts
    dup_args = (counts, starts, s.tile_min, s.tile_max, s.depth, tx, tx * ty,
                budget)
    k1 = lambda gg: (lambda: ops.preprocess_cuda.preprocess_kernel(
        gg, cam, tile=TILE))
    ms = {"preprocess": device_ms(k1(g), KERNEL_REPS, "preprocess_kernel")
          + device_ms(k1(g_obj), KERNEL_REPS, "preprocess_kernel"),
          "duplicate_with_keys": device_ms(
              lambda: ops.fill_cuda.duplicate_with_keys_kernel(*dup_args),
              KERNEL_REPS, "duplicate_kernel"),
          "blend_fwd": device_ms(lambda: ops.blend_cuda.blend_kernel(
              b, s, WIDTH, HEIGHT, TILE), KERNEL_REPS, "blend_kernel")}
    clock = sm_clock_mhz()
    n_live = int((counts > 0).sum())
    _, bst = ops.blend_cuda.blend_train_kernel(b, s, WIDTH, HEIGHT, TILE)
    pairs = pair_counts(P, b, s, bst.n_contrib, WIDTH, HEIGHT, TILE)
    k_rest = g.sh_rest.shape[1]
    w_bg, w_obj = (preprocess_work(x.capacity, k_rest) for x in (g, g_obj))
    work = {"preprocess": tuple(a + c for a, c in zip(w_bg, w_obj)),
            "duplicate_with_keys": duplicate_work(s.radius.shape[0], n_live,
                                                  budget),
            "blend_fwd": blend_work(pairs, n_live)}
    perf = {k: {"edited_frame": timed_bound(ms[k], work[k], clock)}
            for k in work}
    print(f"[{card}] last edited frame: {n_live} live splats, {pairs}; "
          "kernel 1 is its two launches (background and surfels)")
    print_bounds(card, perf, "edited_frame")

    return launches, err, perf, dict(g=g, cams=cams, w=w, inp=inp,
                                      build=build, config=config)


# ---- effects-frame operating point -------------------------------------------


def fields_close(got, want, what: str, tol: float = FIELD_TOL,
                 share: float = FIELD_SHARE) -> float:
    """Each field of ``got`` against ``want`` (NamedTuples of tensors, on
    any devices): within ``tol`` of the field's largest magnitude on at
    least ``share`` of its elements, and all within ``FIELD_MAX_TOL`` of
    it; returns the largest error over the largest magnitude."""
    worst = 0.0
    for name in want._fields:
        a = getattr(got, name).double().cpu()
        b = getattr(want, name).double().cpu()
        check(a.shape == b.shape, f"{what}: {name} shape {a.shape}")
        scale = max(b.abs().max().item(), 1e-12)
        d = (a - b).abs() / scale
        ok = (d <= tol).double().mean().item()
        check(ok >= share and d.max().item() <= FIELD_MAX_TOL,
              f"{what}: {name} off by {d.max().item():.3g} of its largest "
              f"(within {tol:g} on {ok:.5f})")
        worst = max(worst, d.max().item())
    return worst


def card_against_cpu(P) -> dict:
    """The effects' small cases on the card and on the CPU, each held to
    the tolerance of its CPU test: the smoke solve fixed and adaptive at
    R = 24 for 4 frames (and the adaptive origins equal), the lattice
    hash and the display noise bit-equal, ``MeltSim.run`` at R = 32, and
    LPIPS on two 128×128 images, and LaMa at big-lama's widths on one
    128×96 image (the card's cuFFT and cuDNN against the CPU's).
    Returns each case's largest error."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.render import liquid, smoke
    from autovfx_tpu_torch.utils import lpips

    cfg = bench.smoke_config(PARITY_SMOKE_RES)
    err = {}
    for adaptive in (False, True):
        # the adaptive case's emitter sits off the bench's cell R/2: a
        # plume centered there has its centroid on a rounding tie of the
        # recentering shift (R/2 - (R-1)/2 = 0.5), which the order of a
        # float sum decides
        mask = lambda dev: (smoke.sphere_inflow(
            cfg, PARITY_ADAPTIVE_CENTER, 0.06 * cfg.resolution, device=dev)
            if adaptive else bench.smoke_inflow(cfg, dev))
        out = {dev: smoke.simulate_smoke(cfg, mask(dev), PARITY_SMOKE_FRAMES,
                                         adaptive=adaptive)
               for dev in (DEVICE, "cpu")}
        got, want = out[DEVICE], out["cpu"]
        if adaptive:
            check(torch.equal(got[1].cpu(), want[1]),
                  f"adaptive smoke origins {got[1].tolist()} on the card, "
                  f"{want[1].tolist()} on the CPU")
            got, want = got[0], want[0]
        name = "smoke adaptive" if adaptive else "smoke fixed"
        err[name] = fields_close(got, want, name)
    rng = np.random.default_rng(7)
    ix, iy, iz = (rng.integers(-5000, 5000, 100_000) for _ in range(3))
    hashes = [smoke._lattice_hash(*(torch.from_numpy(a).to(dev)
                                    for a in (ix, iy, iz)), 17).cpu()
              for dev in (DEVICE, "cpu")]
    check(torch.equal(*hashes), "the lattice hash differs on the card")
    dens = want.density[-1]
    for frame in (0, 2, 7):
        noise = [smoke.apply_density_noise(dens.to(dev), frame, cfg).cpu()
                 for dev in (DEVICE, "cpu")]
        check(torch.equal(*noise),
              f"apply_density_noise frame {frame} differs on the card")
    pts = np.random.RandomState(0).rand(400, 3).astype(np.float32) * 0.5
    pts[:, :2] -= 0.25
    lcfg = liquid.LiquidConfig(resolution=PARITY_MELT_RES, substeps=4,
                               viscosity=5e-4)
    prog = np.concatenate([np.linspace(0.0, 1.0, 6), np.ones(4)])
    got, want = (liquid.MeltSim(pts, cfg=lcfg, device=dev).run(prog)
                 for dev in (DEVICE, "cpu"))
    rel = lambda a, b: ((a.cpu() - b).abs().max()
                        / b.abs().max().clamp(min=1e-12)).item()
    melt = {k: rel(getattr(got, k), getattr(want, k))
            for k in ("h", "eta", "volume", "tracer_pos")}
    melt["tracer_norm"] = (got.tracer_norm.cpu()
                           - want.tracer_norm).abs().max().item()
    check(max(melt[k] for k in ("h", "eta", "volume")) <= 1e-6
          and melt["tracer_pos"] <= 1e-4 and melt["tracer_norm"] <= 1e-4
          and torch.equal(got.tracer_fluid.cpu(), want.tracer_fluid),
          f"MeltSim.run on the card against the CPU: {melt}")
    err["melt"] = max(melt.values())
    imgs = [torch.from_numpy(rng.random((PARITY_LPIPS, PARITY_LPIPS, 3),
                                        np.float32)) for _ in range(2)]
    d = [lpips.lpips_distance(*(x.to(dev) for x in imgs)).item()
         for dev in (DEVICE, "cpu")]
    check(abs(d[0] - d[1]) <= LPIPS_RTOL * abs(d[1]),
          f"LPIPS {d[0]} on the card, {d[1]} on the CPU")
    err["lpips"] = abs(d[0] - d[1]) / abs(d[1])
    from autovfx_tpu_torch.perception import lama
    from autovfx_tpu_torch.utils.synthetic import lama_state_dict

    sd = lama_state_dict(**LAMA_WIDTHS, seed=0)
    x = torch.from_numpy(rng.random((1, 4) + PARITY_LAMA_HW, np.float32))
    y = {dev: lama.lama_generator(lama.convert_torch_state_dict(
        sd, device=dev), x.to(dev)).cpu() for dev in (DEVICE, "cpu")}
    span = (y["cpu"].max() - y["cpu"].min()).item()
    d_lama = (y[DEVICE] - y["cpu"]).abs().max().item()
    check(bool(torch.isfinite(y[DEVICE]).all())
          and d_lama <= LAMA_RANGE_TOL * span,
          f"LaMa at big-lama's widths on the card against the CPU: max "
          f"difference {d_lama:.3g}, {LAMA_RANGE_TOL} of the output's range "
          f"{span:.3g} allowed")
    err["lama"] = d_lama / span
    print("card against CPU: smoke fixed and adaptive (R = "
          f"{PARITY_SMOKE_RES}, {PARITY_SMOKE_FRAMES} frames) within "
          f"{err['smoke fixed']:.3g} and {err['smoke adaptive']:.3g} of the "
          "largest, origins equal; the lattice hash and the display noise "
          f"bit-equal; MeltSim (R = {PARITY_MELT_RES}) {melt}; LPIPS "
          f"{PARITY_LPIPS}x{PARITY_LPIPS} {d[0]:.6f} / {d[1]:.6f}; LaMa "
          f"{LAMA_WIDTHS} at {PARITY_LAMA_HW[1]}x{PARITY_LAMA_HW[0]} within "
          f"{err['lama']:.3g} of the output's range {span:.3g} (TF32 flags "
          f"at PyTorch's defaults): ok")
    return err


def effects_inputs(P, card: str, inp, build):
    """The bench's effects (bench.py:424-481) on the card: the 96³ smoke
    volume of ``N_CAMS`` frames, the cube's surfels (object-local, as the
    bench passes them) melting linearly over the clip; the clip's inputs
    with both, and their times."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.render import liquid, smoke

    cfg = bench.smoke_config(SMOKE_RES)
    mask = bench.smoke_inflow(cfg, DEVICE)
    states = smoke.simulate_smoke(cfg, mask, N_CAMS)
    for x in states:
        check(bool(torch.isfinite(x).all()), "smoke: not finite")
    check(states.density[-1].max().item() > 0.5, "smoke: no density")
    prog = bench.melt_progress(N_CAMS)
    sim = liquid.MeltSim(inp.surf_points.cpu().numpy(), device=DEVICE)
    mf = sim.run(prog)
    for x in mf:
        check(bool(torch.isfinite(x).all()), "melt: not finite")
    check(mf.tracer_fluid[-1].mean().item() == 1.0, "melt: not all melted")
    inp_fx = build(
        smoke_traj=(states, np.array(bench.SMOKE_ORIGIN, np.float32),
                    bench.SMOKE_EXTENT, cfg),
        melt=dict(pos=mf.tracer_pos, norm=mf.tracer_norm,
                  mask=np.ones(inp.surf_points.shape[0], bool)))
    step_ms = cuda_ms(lambda: smoke.simulate_smoke(cfg, mask, SMOKE_TIMED),
                      3) / SMOKE_TIMED
    step_busy = device_ms(lambda: smoke.step(states_at(states, 3), mask, cfg),
                          KERNEL_REPS, max_lost=1)
    melt_ms = cuda_ms(lambda: sim.run(prog), 3)
    melt_busy = device_ms(lambda: sim.run(prog), 1, max_lost=1)
    lcfg = sim.cfg
    print(f"[{card}] smoke {SMOKE_RES}^3: {step_ms:.3f} ms a step (CUDA "
          f"events over {SMOKE_TIMED} steps), device busy {step_busy:.3f} ms "
          f"a step (profiler); MeltSim.run (R = {lcfg.resolution}, "
          f"{N_CAMS} frames x {lcfg.substeps} substeps): {melt_ms:.3f} ms "
          f"(CUDA events), device busy {melt_busy:.3f} ms; the last frame's "
          f"smoke mass {states.density[-1].sum().item():.1f}, melt volume "
          f"{mf.volume[-1].item():.5f} of {sim.volume:.5f}")
    return cfg, mask, sim, inp_fx


def states_at(states, f: int):
    """Frame ``f`` of stacked smoke states."""
    return type(states)(*(x[f] for x in states))


def effects_stages(P, inp, i, config, cfg):
    """The effects frame's stages on frame ``i``, as functions of nothing,
    each from the outputs of the stages before it (made once here)."""
    from autovfx_tpu_torch.core.cameras import index_camera
    from autovfx_tpu_torch.ops import binning, blend_cuda, preprocess_cuda
    from autovfx_tpu_torch.ops.projection import Splats2D, empty_splats
    from autovfx_tpu_torch.ops.rasterize import (RenderOutput, rasterize,
                                                 rasterize_multi)
    from autovfx_tpu_torch.render import clip, shadow

    cam = index_camera(inp.cams, i)
    g_obj = clip.shaded_object_gaussians(inp, i, cam)
    g_smoke, g_fire = clip.smoke_gaussians(inp, i, cfg)
    sets = [inp.bg, g_obj, g_smoke]
    buf = empty_splats(sum(x.capacity for x in sets), DEVICE)
    off = 0
    for x in sets:
        preprocess_cuda.preprocess(x, cam, tile=TILE, out=Splats2D(
            *(f[off:off + x.capacity] for f in buf)))
        off += x.capacity
    binned = binning.bin_splats(buf, cam.width, cam.height, config.dup_budget,
                                tile=TILE)
    color, depth, alpha = blend_cuda.blend(binned, buf, cam.width, cam.height,
                                           TILE)
    out = RenderOutput(color, depth, alpha, buf.radius, binned.overflow)
    fire_cfg = clip.fire_config(config)
    fire_s = preprocess_cuda.preprocess(g_fire, cam, tile=TILE)
    fire_b = binning.bin_splats(fire_s, cam.width, cam.height,
                                fire_cfg.dup_budget, tile=TILE)
    fire_imgs = blend_cuda.blend(fire_b, fire_s, cam.width, cam.height, TILE)
    a = alpha.clamp(0.0, 1.0)
    planes = clip.world_hull_planes_at(inp, i)
    w_obj = shadow.hull_object_weight(cam, clip.pass_depth(out, a), planes,
                                      inp.hull_mask, pad=clip.object_pad(inp))
    ratio = shadow.shadow_ratio_map(
        cam, depth, a.clamp(min=1e-3), inp.light_dirs, inp.light_weights,
        planes, inp.hull_mask, scale=SHADOW_SCALE)
    stages = {
        "noise + splat conversion": lambda: clip.smoke_gaussians(inp, i, cfg),
        "object shading": lambda: clip.shaded_object_gaussians(inp, i, cam),
        "merged render": lambda: rasterize_multi(sets, cam, config=config),
        "fire render": lambda: rasterize(g_fire, cam, config=fire_cfg),
        "hull weight": lambda: shadow.hull_object_weight(
            cam, clip.pass_depth(out, a), clip.world_hull_planes_at(inp, i),
            inp.hull_mask, pad=clip.object_pad(inp)),
        "shadow ratio": lambda: shadow.shadow_ratio_map(
            cam, depth, a.clamp(min=1e-3), inp.light_dirs, inp.light_weights,
            planes, inp.hull_mask, scale=SHADOW_SCALE),
        "composite": lambda: clip.fused_composite(out, ratio, w_obj,
                                                  fire_imgs[0]),
    }
    return dict(cam=cam, sets=sets, g_fire=g_fire, splats=buf, binned=binned,
                images=(color, depth, alpha), fire_splats=fire_s,
                fire_binned=fire_b, fire_images=fire_imgs, stages=stages)


def effects_visible(P, inp, g, config, cfg, frame: int) -> dict:
    """On the scene ``g``: the pixels of frame ``frame`` that differ by
    > 0.05 between the effects frame and the same frame without the
    volume (smoke and fire), the energy the effects add, and the pixels
    the smoke set alone moves in the merged render."""
    from autovfx_tpu_torch.core.cameras import index_camera
    from autovfx_tpu_torch.render import clip

    inp = dataclasses.replace(inp, bg=g)
    fx = clip.render_edited_frame_fused(inp, frame, config,
                                        shadow_scale=SHADOW_SCALE,
                                        smoke_cfg=cfg)
    plain = clip.render_edited_frame_fused(
        dataclasses.replace(inp, smoke_density=None), frame, config,
        shadow_scale=SHADOW_SCALE)
    cam = index_camera(inp.cams, frame)
    g_obj = clip.shaded_object_gaussians(inp, frame, cam)
    g_smoke, _ = clip.smoke_gaussians(inp, frame, cfg)
    with_smoke = P.rasterize_multi([g, g_obj, g_smoke], cam, config=config)
    no_smoke = P.rasterize_multi([g, g_obj], cam, config=config)
    check(not bool(with_smoke.overflow), "effects visibility: overflow")
    return {
        "changed": int(((fx - plain).abs().amax(-1) > 0.05).sum()),
        "energy": (fx.double().sum() - plain.double().sum()).item(),
        "smoke_changed": int(((with_smoke.color - no_smoke.color).abs()
                              .amax(-1) > 0.05).sum()),
        "finite": bool(torch.isfinite(fx).all()),
    }


def fire_tiles(binned, rng, n: int) -> torch.Tensor:
    """Up to ``n`` seeded tiles that hold fire duplicates."""
    r = binned.tile_range
    live = torch.nonzero(r[:, 1] > r[:, 0]).flatten().cpu().numpy()
    pick = rng.choice(live, min(n, len(live)), replace=False)
    return torch.from_numpy(pick).to(binned.gid.device)


def effects_frame_point(P, card: str, edit: dict):
    """The effects frame at the operating point of the JAX package's
    bench.py:424-481 on the edited frame's scene, ring, drop and surfels,
    through ``render_clip(fused=True, smoke_cfg=...)``."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.ops.rasterize import preprocess_sets
    from autovfx_tpu_torch.render import clip, liquid, smoke

    ops = P.ops
    g, cams, inp = edit["g"], edit["cams"], edit["inp"]
    cfg, mask, sim, inp_fx = effects_inputs(P, card, inp, edit["build"])
    worst = fire_worst = 0
    live = []
    for i, cam in enumerate(cams):
        g_obj = clip.shaded_object_gaussians(inp_fx, i, cam)
        g_smoke, g_fire = clip.smoke_gaussians(inp_fx, i, cfg)
        s = preprocess_sets([g, g_obj, g_smoke], cam,
                            P.RasterConfig(tile=TILE))
        worst = max(worst, int(ops.binning.required_budget(s)))
        fire_worst = max(fire_worst, int(ops.binning.required_budget(
            ops.preprocess_cuda.preprocess(g_fire, cam, tile=TILE))))
        live.append((int(g_smoke.active.sum()), int(g_fire.active.sum())))
    budget = ops.binning.round_budget(worst, slack=BUDGET_SLACK)
    config = P.RasterConfig(dup_budget=budget, tile=TILE)
    fire_budget = clip.fire_config(config).dup_budget
    check(fire_worst <= fire_budget,
          f"the fire render needs {fire_worst} duplicates, over its "
          f"budget {fire_budget}")
    print(f"effects duplicates: worst merged view with smoke {worst}, budget "
          f"{budget}; fire worst {fire_worst}, budget {fire_budget}; live "
          f"(smoke, fire) splats a frame {live} of "
          f"{g_smoke.capacity} slots")

    # the main path, counted
    sync()
    P.utils.trace.reset()
    frames = clip.render_clip(inp_fx, N_CAMS, config, fused=True,
                              smoke_cfg=cfg)
    sync()
    launches = bench.kernel_launches()
    check_launches(launches, {"preprocess": 4 * N_CAMS,
                              "duplicate_with_keys": 2 * N_CAMS,
                              "blend_fwd": 2 * N_CAMS},
                   f"{N_CAMS} effects frames")
    check(frames.shape == (N_CAMS, HEIGHT, WIDTH, 3), "effects frames: shape")
    check(bool(torch.isfinite(frames).all()), "effects frames: not finite")
    check(frames.min().item() >= 0.0 and frames.max().item() <= 1.0,
          "effects frames: outside [0, 1]")

    # each frame's kernels against their plain versions, on the merged set
    # with smoke and on the fire set; neither render overflows
    tx, ty = ops.projection.num_tiles(WIDTH, HEIGHT, TILE)
    rng = np.random.default_rng(6)
    err = {}
    for i in range(N_CAMS):
        st = effects_stages(P, inp_fx, i, config, cfg)
        what = f"effects frame {i}"
        check(not bool(st["binned"].overflow), f"{what}: merged overflow")
        check(not bool(st["fire_binned"].overflow), f"{what}: fire overflow")
        tiles = torch.from_numpy(
            rng.choice(tx * ty, CHECK_TILES, replace=False)).to(DEVICE)
        e3 = check_blend(P, st["binned"], st["splats"], st["images"], tiles,
                         WIDTH, HEIGHT, TILE, f"{what} merged")
        e3f = check_blend(P, st["fire_binned"], st["fire_splats"],
                          st["fire_images"],
                          fire_tiles(st["fire_binned"], rng, CHECK_TILES),
                          WIDTH, HEIGHT, TILE, f"{what} fire")
        err["blend_fwd"] = max(err.get("blend_fwd", 0.0), e3, e3f)
        sync()
    cam, g_smoke, g_fire = st["cam"], st["sets"][2], st["g_fire"]
    err["preprocess"] = max(
        check_preprocess(ops.preprocess_cuda.preprocess_kernel(x, cam,
                                                               tile=TILE),
                         ops.projection.preprocess(x, cam, tile=TILE),
                         f"{what} {name}")
        for name, x in (("smoke", g_smoke), ("fire", g_fire)))
    err["duplicate_with_keys"] = max(
        check_duplicates(P, st["splats"], tx, tx * ty, budget,
                         f"{what} merged"),
        check_duplicates(P, st["fire_splats"], tx, tx * ty, fire_budget,
                         f"{what} fire"))

    # the smoke and fire in view: the plume rises inside the scene's
    # clutter, so the smoke alone is also checked over the ground disc
    last = N_CAMS - 1
    seen = {name: effects_visible(P, inp_fx, scene, config, cfg, last)
            for name, scene in (("bench scene", g),
                                ("ground disc", ground_disc(g)))}
    for name, v in seen.items():
        check(v["finite"], f"effects frame over the {name}: not finite")
    bench, disc = seen["bench scene"], seen["ground disc"]
    check(bench["changed"] > EFFECTS_PIXELS_MIN and bench["energy"] > 0,
          f"effects frame {last} over the bench scene: {bench}")
    check(disc["changed"] > EFFECTS_PIXELS_MIN
          and disc["smoke_changed"] > EFFECTS_PIXELS_MIN
          and disc["energy"] > 0,
          f"effects frame {last} over the ground disc: {disc}")
    print(f"effects frames: {launches}; frame {last}: " + "; ".join(
        f"over the {name}: {v['changed']} pixels differ from the frame "
        f"without the volume by > 0.05, the effects add {v['energy']:.1f} "
        f"of color, the smoke set alone moves {v['smoke_changed']} pixels "
        "of the merged render" for name, v in seen.items())
        + f"; checks at {N_SPLATS} + {EDIT_SURFELS} + {g_smoke.capacity} "
        f"slots {WIDTH}x{HEIGHT} tile {TILE}: kernel 1 on the smoke and "
        f"fire sets, kernel 2 on the merged and fire sets, kernel 3 on "
        f"{CHECK_TILES} tiles/frame of each against the plain versions: ok")

    # no host syncs, then times
    def frame(i):
        return clip.render_edited_frame_fused(inp_fx, i % N_CAMS, config,
                                              shadow_scale=SHADOW_SCALE,
                                              smoke_cfg=cfg)

    for i in range(WARMUP):
        frame(i)
    state = states_at(smoke.simulate_smoke(cfg, mask, 2), 1)
    h = torch.rand(sim.cfg.resolution, sim.cfg.resolution, device=DEVICE)
    txy = torch.rand(1000, 2, device=DEVICE) * (sim.cfg.resolution - 1)

    def liquid_substep():
        h2, u = liquid._substep(h * 0.01, sim.bed, sim.footprint * 1e-5,
                                sim.cell, sim.cfg)
        return h2, liquid._bilinear(u[..., 0], txy)

    no_syncs(lambda: frame(N_CAMS - 1), "the effects frame")
    no_syncs(lambda: smoke.simulate_smoke(cfg, mask, 1, adaptive=True),
             "an adaptive smoke step")
    no_syncs(lambda: smoke.step(state, mask, cfg), "a smoke step")
    no_syncs(liquid_substep, "a liquid substep")
    print("the effects frame, an adaptive and a fixed smoke step and a "
          "liquid substep read nothing back from the card (sync debug "
          "mode): ok")
    names = [e.name() for e in profiled(lambda: frame(N_CAMS - 1), 1)]
    per_frame = {k: sum(k in x for x in names)
                 for k in ("preprocess_kernel", "duplicate_kernel",
                           "blend_kernel")}
    check(per_frame == {"preprocess_kernel": 4, "duplicate_kernel": 2,
                        "blend_kernel": 2},
          f"the profiler's kernel records of one effects frame: {per_frame}")
    torch.cuda.reset_peak_memory_stats()
    frame_ms = [cuda_ms(lambda i=i: frame(i), 1) for i in range(TIMED)]
    peak = torch.cuda.max_memory_allocated()
    median = statistics.median(frame_ms)
    print(f"[{card}] effects frame {WIDTH}x{HEIGHT} tile {TILE} (bench "
          f"scene): median {median:.3f} ms over {TIMED} frames (min "
          f"{min(frame_ms):.3f}, max {max(frame_ms):.3f}); "
          f"{1000.0 / median:.1f} frames/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; the profiler's kernel records of one "
          f"frame: {per_frame} of {len(names)}")
    run = lambda: [frame(i) for i in range(TIMED)]
    streamed = cuda_ms(run, 3) / TIMED
    records = profiled(run, 1)
    busy = sum(e.duration_ns() for e in records) / 1e6 / TIMED
    print(f"[{card}] {TIMED} effects frames back to back: {streamed:.3f} "
          f"ms/frame, device busy {busy:.3f} ms/frame, idle share "
          f"{1.0 - busy / streamed:.3f}; {len(records) / TIMED:.0f} device "
          "records (kernels, copies) a frame")
    stage_ms = {k: device_ms(fn, KERNEL_REPS, max_lost=1)
                for k, fn in st["stages"].items()}
    print(f"[{card}] effects frame device time by stage (ms, profiler, last "
          "frame): " + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f"; sum {sum(stage_ms.values()):.3f}")

    # kernels 1-3 on the last frame's shapes: kernel 1 is its four
    # launches, kernels 2 and 3 their two (merged set, fire set)
    s, b, fs, fb = (st["splats"], st["binned"], st["fire_splats"],
                    st["fire_binned"])
    k1 = lambda gg: (lambda: ops.preprocess_cuda.preprocess_kernel(
        gg, cam, tile=TILE))

    def k2(x, bud):
        counts = x.tiles_touched
        args = (counts, torch.cumsum(counts, 0) - counts, x.tile_min,
                x.tile_max, x.depth, tx, tx * ty, bud)
        return lambda: ops.fill_cuda.duplicate_with_keys_kernel(*args)

    k3 = lambda bb, xx: (lambda: ops.blend_cuda.blend_kernel(
        bb, xx, WIDTH, HEIGHT, TILE))
    all_sets = st["sets"] + [g_fire]
    ms = {"preprocess": sum(device_ms(k1(x), KERNEL_REPS, "preprocess_kernel")
                            for x in all_sets),
          "duplicate_with_keys": device_ms(k2(s, budget), KERNEL_REPS,
                                           "duplicate_kernel")
          + device_ms(k2(fs, fire_budget), KERNEL_REPS, "duplicate_kernel"),
          "blend_fwd": device_ms(k3(b, s), KERNEL_REPS, "blend_kernel")
          + device_ms(k3(fb, fs), KERNEL_REPS, "blend_kernel")}
    clock = sm_clock_mhz()
    k_rest = g.sh_rest.shape[1]
    work = {"preprocess": tuple(map(sum, zip(*(
        preprocess_work(x.capacity, x.sh_rest.shape[1]) for x in all_sets))))}
    pairs = {}
    dup, blend = [], []
    for name, (bb, xx, bud) in (("merged", (b, s, budget)),
                                ("fire", (fb, fs, fire_budget))):
        n_live = int((xx.tiles_touched > 0).sum())
        _, bst = ops.blend_cuda.blend_train_kernel(bb, xx, WIDTH, HEIGHT,
                                                   TILE)
        pairs[name] = pair_counts(P, bb, xx, bst.n_contrib, WIDTH, HEIGHT,
                                  TILE)
        dup.append(duplicate_work(xx.radius.shape[0], n_live, bud))
        blend.append(blend_work(pairs[name], n_live))
    work["duplicate_with_keys"] = tuple(map(sum, zip(*dup)))
    work["blend_fwd"] = tuple(map(sum, zip(*blend)))
    perf = {k: {"effects_frame": timed_bound(ms[k], work[k], clock)}
            for k in work}
    print(f"[{card}] last effects frame: merged {pairs['merged']}; fire "
          f"{pairs['fire']}; SH rest {k_rest}; kernel 1 is its four launches "
          "(background, surfels, smoke, fire), kernels 2 and 3 their two "
          "(merged set, fire set)")
    print_bounds(card, perf, "effects_frame")
    return launches, err, perf


# ---- panorama -------------------------------------------------------------------


def panorama_point(P, card: str, g) -> tuple[dict, dict]:
    """``render_panorama`` of the bench scene from inside its clutter at
    face 512: six faces through kernels 1-3, counted; the first face's
    kernels against their plain versions."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.render import panorama

    ops = P.ops
    cams = panorama.face_cameras(PANORAMA_CENTER, PANORAMA_FACE, DEVICE)
    worst = max(int(ops.binning.required_budget(
        ops.preprocess_cuda.preprocess(g, c, tile=TILE))) for c in cams)
    budget = ops.binning.round_budget(worst, slack=BUDGET_SLACK)
    config = P.RasterConfig(dup_budget=budget, tile=TILE)
    sync()
    P.utils.trace.reset()
    t0 = time.perf_counter()
    pano = panorama.render_panorama(g, PANORAMA_CENTER,
                                    face_size=PANORAMA_FACE,
                                    out_height=PANORAMA_FACE, config=config)
    wall = time.perf_counter() - t0
    launches = bench.kernel_launches()
    n = len(panorama.FACES)
    check_launches(launches, {"preprocess": n, "duplicate_with_keys": n,
                              "blend_fwd": n}, "the panorama")
    check(pano.shape == (PANORAMA_FACE, 2 * PANORAMA_FACE, 3)
          and np.isfinite(pano).all(), "panorama: shape or not finite")
    seen = float((pano > 0.05).mean())
    check(seen > 0.3, f"panorama: {seen:.3f} of its texels see splats")
    cam = cams[0]
    what = f"panorama face 0 ({PANORAMA_FACE}^2)"
    s = ops.preprocess_cuda.preprocess_kernel(g, cam, tile=TILE)
    err = {"preprocess": check_preprocess(
        s, ops.projection.preprocess(g, cam, tile=TILE), what)}
    tx, ty = ops.projection.num_tiles(PANORAMA_FACE, PANORAMA_FACE, TILE)
    err["duplicate_with_keys"] = check_duplicates(P, s, tx, tx * ty, budget,
                                                  what)
    b = ops.binning.bin_splats(s, PANORAMA_FACE, PANORAMA_FACE, budget,
                               tile=TILE)
    check(not bool(b.overflow), f"{what}: overflow")
    imgs = ops.blend_cuda.blend_kernel(b, s, PANORAMA_FACE, PANORAMA_FACE,
                                       TILE)
    tiles = torch.from_numpy(np.random.default_rng(8).choice(
        tx * ty, min(CHECK_TILES, tx * ty), replace=False)).to(DEVICE)
    err["blend_fwd"] = check_blend(P, b, s, imgs, tiles, PANORAMA_FACE,
                                   PANORAMA_FACE, TILE, what)
    print(f"[{card}] panorama of the bench scene from {PANORAMA_CENTER} at "
          f"face {PANORAMA_FACE}: {wall * 1000.0:.1f} ms wall (six faces + "
          f"the host resample), budget {budget}, {seen:.3f} of its texels "
          f"see splats, {launches}; face 0's kernels against their plain "
          "versions: ok")
    return launches, err


# ---- the edit program ----------------------------------------------------------


def table_frame():
    """The table's center (x, y) and the unit vectors along (ahead) and
    across (side) camera 0's view on the ground."""
    from autovfx_tpu_torch import bench

    cam0 = bench.ring_cameras(WIDTH, HEIGHT, N_CAMS, DEVICE)[0]
    eye = cam0.center.cpu().numpy().astype(np.float64)
    ahead = -eye[:2] / np.linalg.norm(eye[:2])  # the ring looks inward
    return eye[:2] + TABLE_AHEAD * ahead, ahead, np.array([-ahead[1],
                                                           ahead[0]])


def table_geometry():
    """The table's mesh (8 vertices, 12 faces counterclockwise from
    outside: the top split along the diagonal from the near corner on
    the camera's left to the far one on its right) and its splats'
    seeded positions filling the box."""
    center, ahead, side = table_frame()
    h = TABLE_SIDE / 2
    ring = [center - h * ahead + h * side, center - h * ahead - h * side,
            center + h * ahead - h * side, center + h * ahead + h * side]
    verts = np.array([[x, y, z] for z in (0.0, TABLE_TOP) for x, y in ring],
                     np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5],
                      [0, 5, 4], [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6],
                      [3, 0, 4], [3, 4, 7]], np.int64)
    u = np.random.default_rng(11).random((EDIT_TABLE_SPLATS, 3))
    xy = (center + ((u[:, :1] - 0.5) * TABLE_SIDE) * ahead
          + ((u[:, 1:2] - 0.5) * TABLE_SIDE) * side)
    xyz = np.concatenate([xy, TABLE_TOP * u[:, 2:]], 1).astype(np.float32)
    return verts, faces, xyz


def inside_table(points: np.ndarray, margin: float) -> np.ndarray:
    """Which points lie in the table's box grown by ``margin``."""
    center, ahead, side = table_frame()
    d = points[:, :2] - center
    h = TABLE_SIDE / 2 + margin
    return ((np.abs(d @ ahead) <= h) & (np.abs(d @ side) <= h)
            & (points[:, 2] >= -margin) & (points[:, 2] <= TABLE_TOP + margin))


def closest_triangle(points: np.ndarray, verts: np.ndarray,
                     faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N,) the index of each point's nearest triangle by brute force in
    float64 (the lower index at a tie) and its squared distance:
    Ericson's closest point on a triangle, one triangle at a time."""
    p = points.astype(np.float64)
    best = np.full(len(p), np.inf)
    idx = np.zeros(len(p), np.int64)
    dot = lambda x, y: (x * y).sum(-1)
    for t, (a, b, c) in enumerate(verts[faces].astype(np.float64)):
        ab, ac, ap, bp, cp = b - a, c - a, p - a, p - b, p - c
        d1, d2, d3, d4, d5, d6 = (dot(ap, ab), dot(ap, ac), dot(bp, ab),
                                  dot(bp, ac), dot(cp, ab), dot(cp, ac))
        va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
        # Ericson's regions, the first that holds wins: corner a, corner
        # b, edge ab, corner c, edge ac, edge bc, the face
        with np.errstate(divide="ignore", invalid="ignore"):
            regions = [
                ((d1 <= 0) & (d2 <= 0), a + 0 * ap),
                ((d3 >= 0) & (d4 <= d3), b + 0 * ap),
                ((vc <= 0) & (d1 >= 0) & (d3 <= 0),
                 a + (d1 / (d1 - d3))[:, None] * ab),
                ((d6 >= 0) & (d5 <= d6), c + 0 * ap),
                ((vb <= 0) & (d2 >= 0) & (d6 <= 0),
                 a + (d2 / (d2 - d6))[:, None] * ac),
                ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
                 b + ((d4 - d3) / ((d4 - d3) + (d5 - d6)))[:, None] * (c - b)),
            ]
            denom = 1.0 / (va + vb + vc)
            q = a + (vb * denom)[:, None] * ab + (vc * denom)[:, None] * ac
        for hold, point in regions[::-1]:
            q = np.where(hold[:, None], point, q)
        dist = dot(p - q, p - q)
        closer = dist < best
        best = np.where(closer, dist, best)
        idx = np.where(closer, t, idx)
    return idx, best


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """The convex hull of 2-D points, counterclockwise (monotone chain)."""
    pts = sorted(map(tuple, pts))
    cross = lambda o, a, b: ((a[0] - o[0]) * (b[1] - o[1])
                             - (a[1] - o[1]) * (b[0] - o[0]))
    lower, upper = [], []
    for seq, out in ((pts, lower), (pts[::-1], upper)):
        for q in seq:
            while len(out) >= 2 and cross(out[-2], out[-1], q) <= 0:
                out.pop()
            out.append(q)
    return np.array(lower[:-1] + upper[:-1])


def in_polygon(hull: np.ndarray, height: int, width: int,
               grow: float) -> torch.Tensor:
    """(H, W) which pixel centers lie inside the convex polygon ``hull``
    with every edge moved out by ``grow`` px (in, where negative)."""
    j, i = torch.meshgrid(torch.arange(height, dtype=torch.float64) + 0.5,
                          torch.arange(width, dtype=torch.float64) + 0.5,
                          indexing="ij")
    inside = torch.ones(height, width, dtype=torch.bool)
    mid = hull.mean(0)
    for a, b in zip(hull, np.roll(hull, -1, 0)):
        n = np.array([b[1] - a[1], a[0] - b[0]]) / np.linalg.norm(b - a)
        if n @ (mid - a) < 0:
            n = -n  # toward the inside
        inside &= (i - a[0]) * n[0] + (j - a[1]) * n[1] >= -grow
    return inside


def edit_program_files(P, root: str) -> dict:
    """The program's inputs under ``root``: the bench scene and the table
    as one PLY, the ground quad and the table box as the scene mesh, the
    ring's trajectory, the cube, the table's DEVA masks (its splats alone
    through each ring view on the card, alpha > 0.4, as PNGs) and the
    program."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.core import cameras, ply_io
    from autovfx_tpu_torch.core.gaussians import merge
    from autovfx_tpu_torch.edit import mesh_io
    from autovfx_tpu_torch.utils import png
    from autovfx_tpu_torch.utils.synthetic import make_garden_like, \
        make_gaussians

    t0 = time.perf_counter()
    t_verts, t_faces, t_xyz = table_geometry()
    table = make_gaussians(EDIT_TABLE_SPLATS, np.random.default_rng(12),
                           scale_range=(0.01, 0.03), device="cpu")
    table = dataclasses.replace(table, xyz=torch.from_numpy(t_xyz))
    g = merge(make_garden_like(N_SPLATS, seed=0, extent=EXTENT,
                               device="cpu"), table)
    ply = os.path.join(root, "scene.ply")
    ply_io.save_ply(ply, g)
    ground = np.array([[-10, -10, 0], [10, -10, 0], [10, 10, 0],
                       [-10, 10, 0]], np.float32)
    mesh = os.path.join(root, "scene_mesh.obj")
    mesh_io.save_obj(mesh, mesh_io.Mesh(
        np.concatenate([ground, t_verts]),
        np.concatenate([[[0, 1, 2], [0, 2, 3]], t_faces + 4])))
    cube = os.path.join(root, "cube.obj")
    corners = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                        for z in (-0.5, 0.5)], np.float32)
    mesh_io.save_obj(cube, mesh_io.Mesh(corners, CUBE_FACES))
    cams = cameras.stack_cameras(
        bench.ring_cameras(WIDTH, HEIGHT, N_CAMS, DEVICE))
    cameras.save_custom_trajectory(
        os.path.join(root, "custom_camera_path", "ring.json"), cams)
    masks = os.path.join(root, "cache", "tracking", "table", "1")
    os.makedirs(masks)
    table = dataclasses.replace(table, **{
        f.name: getattr(table, f.name).to(DEVICE)
        for f in dataclasses.fields(table)})
    config = P.RasterConfig(dup_budget=1 << 22, tile=EDIT_TILE)
    mask_px = []
    for i in range(N_CAMS):
        out = P.rasterize(table, cameras.index_camera(cams, i), config=config)
        check(not bool(out.overflow), f"table mask {i}: overflow")
        m = (out.alpha > 0.4).cpu().numpy()
        mask_px.append(int(m.sum()))
        png.write_png(os.path.join(masks, f"{i:05d}.png"),
                      m.astype(np.uint8) * 255)
    # the table stands in front of camera 0: the ring's two neighbours
    # of camera 0 do not see it, as a tracker loses an object out of view
    check(mask_px[0] > 0 and sum(m > 0 for m in mask_px) >= N_CAMS // 2,
          f"the ring views see too little of the table: {mask_px}")
    program = os.path.join(root, "program.py")
    with open(program, "w") as f:
        f.write('table = detect_object(scene, "table")\n'
                f"pos = sample_point_above_object(scene, table, "
                f"VERTICAL_OFFSET={DROP_OFFSET})\n"
                "obj = get_default_object_info()\n"
                f'obj["object_path"] = {cube!r}\n'
                'obj["object_name"] = "cube"\n'
                'obj["pos"] = pos\n'
                'obj["scale"] = 0.3\n'
                "obj = allow_physics(obj)\n"
                "insert_object(scene, obj)\n")
    print(f"edit program inputs: {g.capacity} splats ({EDIT_TABLE_SPLATS} "
          f"of them the table) in a {os.path.getsize(ply) / 2**20:.1f} MiB "
          f"PLY, table masks of {mask_px} pixels, in "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(ply=ply, mesh=mesh, program=program, root=root)


class StageClock:
    """Wall time and ``SceneRepresentation.rasterize`` calls of named
    stages, each ended by a device synchronize."""

    def __init__(self):
        self.stages = {}
        self.renders = 0

    def wrap(self, owner, attr: str, stage, keep=None):
        """Time each call of ``owner.attr`` as ``stage`` (a name, or a
        function of the call's number that gives a name or None: not
        timed); ``keep(result, *a, **k)`` sees each result."""
        fn = getattr(owner, attr)
        calls = [0]

        def timed(*a, **k):
            name = stage(calls[0]) if callable(stage) else stage
            calls[0] += 1
            if name is None:
                out = fn(*a, **k)
            else:
                sync()
                renders = self.renders
                t0 = time.perf_counter()
                out = fn(*a, **k)
                sync()
                rec = self.stages.setdefault(name, {"s": 0.0, "renders": 0})
                rec["s"] += time.perf_counter() - t0
                rec["renders"] += self.renders - renders
            if keep is not None:
                keep(out, *a, **k)
            return out

        setattr(owner, attr, timed)

    def exclusive(self, outer: str, inner: str) -> None:
        """Take ``inner``'s time and renders out of ``outer``'s (a stage
        that runs inside another)."""
        o, i = self.stages[outer], self.stages[inner]
        o["s"] -= i["s"]
        o["renders"] -= i["renders"]


def edit_program_point(P, card: str) -> tuple[dict, dict]:
    """The port's edit entry, ``edit_scene.run_scene_editing``, on the
    bench scene with a table at full width: the preamble's render, detect
    -> extract on the table's masks, the program, physics and
    ``render_scene`` over the 8 ring views, each stage timed and
    counted; then its results checked."""
    import random

    from autovfx_tpu_torch import bench, edit_scene
    from autovfx_tpu_torch.core import ply_io
    from autovfx_tpu_torch.core.cameras import index_camera
    from autovfx_tpu_torch.core.quaternion import euler_to_rotmat
    from autovfx_tpu_torch.edit import edit_ir, edit_utils, mesh_io
    from autovfx_tpu_torch.edit import scene_representation as SR
    from autovfx_tpu_torch.gpt import lmp
    from autovfx_tpu_torch.physics import solver
    from autovfx_tpu_torch.render import meshsplat
    from autovfx_tpu_torch.utils import png

    ops = P.ops
    # the cube's path is written into the generated program, which the
    # program refuses if it holds a banned phrase such as "__": draw the
    # directory again until its random name holds none
    tmp = tempfile.TemporaryDirectory()
    while any(phrase in tmp.name for phrase in lmp._BANNED):
        tmp.cleanup()
        tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    files = edit_program_files(P, root)
    # the budget: the worst ring view of the background and of the cube's
    # 60,000 surfels resting on either of its landing points
    g = ply_io.load_ply(files["ply"], device=DEVICE)
    t_verts, t_faces, _ = table_geometry()
    top = t_verts[4:]
    landings = [top[[0, 1, 2]].mean(0), top[[0, 2, 3]].mean(0)]
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32) * CUBE_HALF
    need = lambda x, c: int(ops.binning.required_budget(
        ops.preprocess_cuda.preprocess(x, c, tile=EDIT_TILE)))
    ring = bench.ring_cameras(WIDTH, HEIGHT, N_CAMS, DEVICE)
    worst = max(need(g, c) for c in ring)
    for land in landings:
        surf = meshsplat.sample_mesh_surfels(
            corners + land + [0, 0, CUBE_HALF], CUBE_FACES, 60_000,
            device=DEVICE)
        cube = meshsplat.surfels_to_gaussians(
            surf["points"], surf["normals"], surf["colors"], surf["radius"])
        worst = max(worst, max(need(cube, c) for c in ring))
    budget = ops.binning.round_budget(worst, slack=BUDGET_SLACK)
    del g, surf, cube
    print(f"edit program duplicates: worst view {worst}, budget {budget}")
    opts = edit_scene.get_opts([
        "--source_path", root, "--model_path", root,
        "--gaussians_ckpt_path", files["ply"],
        "--scene_mesh_path", files["mesh"], "--custom_traj_name", "ring",
        "--dup_budget", str(budget), "--edit_text", "Drop a cube on the table.",
        "--offline_program", files["program"], "--device", DEVICE])

    # the stages, timed; the renders counted; the scene and its anchor
    # frame's shadow pass and its inputs kept for the checks
    clock = StageClock()
    seen = {}
    scene_cls = SR.SceneRepresentation
    saved = {k: getattr(scene_cls, k) for k in (
        "rasterize", "render_from_3DGS", "run_physics", "render_scene",
        "render_frame", "render_shadow_pass")}
    saved_detect, saved_call = edit_utils.detect_object, lmp.LMP.__call__

    def count_render(self, *a, **k):
        clock.renders += 1
        return saved["rasterize"](self, *a, **k)

    def keep_scene(_, self, *a, **k):
        seen["scene"] = self

    def keep_frame(_, self, fi, color, depth, alpha):
        if fi == self.hparams.anchor_frame_idx:
            seen.update(bg=color, depth=depth, alpha=alpha)

    def keep_shadow(ratio, self, fi, depth, alpha):
        if fi == self.hparams.anchor_frame_idx:
            seen["ratio"] = ratio

    scene_cls.rasterize = count_render
    clock.wrap(scene_cls, "render_from_3DGS",
               lambda n: "preamble" if n == 0 else None)
    clock.wrap(scene_cls, "run_physics", "physics")
    clock.wrap(scene_cls, "render_scene", "render_scene", keep=keep_scene)
    clock.wrap(scene_cls, "render_frame", lambda n: None, keep=keep_frame)
    clock.wrap(scene_cls, "render_shadow_pass", lambda n: None,
               keep=keep_shadow)
    clock.wrap(edit_utils, "detect_object", "detect+extract")
    clock.wrap(lmp.LMP, "__call__", "program")
    random.seed(0)
    np.random.seed(0)
    torch.cuda.reset_peak_memory_stats()
    sync()
    P.utils.trace.reset()
    t0 = time.perf_counter()
    try:
        frames = edit_scene.run_scene_editing(opts, opts.edit_text,
                                              opts.offline_program)
        sync()
    finally:
        for k, fn in saved.items():
            setattr(scene_cls, k, fn)
        edit_utils.detect_object, lmp.LMP.__call__ = saved_detect, saved_call
    wall = time.perf_counter() - t0
    launches = bench.kernel_launches()
    fields = field_launches()
    peak = torch.cuda.max_memory_allocated()
    st = clock.stages
    # physics runs inside render_scene, detect inside the program
    clock.exclusive("render_scene", "physics")
    clock.exclusive("program", "detect+extract")
    scene = seen["scene"]
    anchor = scene.hparams.anchor_frame_idx

    # the frames and the files
    check(tuple(frames.shape) == (N_CAMS, HEIGHT, WIDTH, 3),
          f"edit program frames: shape {tuple(frames.shape)}")
    check(frames.device.type == torch.device(DEVICE).type,
          "edit program frames: not on the device")
    check(bool(torch.isfinite(frames).all()), "edit program frames: finite")
    check(frames.min().item() >= 0.0 and frames.max().item() <= 1.0,
          "edit program frames: outside [0, 1]")
    cache = os.path.join(root, "cache")
    blended = os.path.join(cache, "blender_output", "blended")
    for i in range(N_CAMS):
        img = png.read_png(os.path.join(blended, f"{i:04d}.png"))
        check(img.shape == (HEIGHT, WIDTH, 3), f"blended PNG {i}: shape")
    cfg = edit_ir.EditConfig.from_json(os.path.join(cache,
                                                    "edit_config.json"))
    check(cfg.num_frames == N_CAMS and len(cfg.insert_object_info) == 1,
          "edit_config.json: frames or objects")
    oid = cfg.insert_object_info[0]["object_id"]
    check(not bool(scene.overflowed), "edit program: duplicate overflow")

    # the extraction: the table's triangles, and the splats whose nearest
    # scene-mesh triangle is one of them
    base = os.path.join(cache, "extract", "table", "1")
    obj_mesh = mesh_io.load_mesh(os.path.join(base, "object_mesh",
                                              "object_mesh.obj"))
    check(len(obj_mesh.faces) > 0 and bool(
        inside_table(obj_mesh.vertices, TABLE_MARGIN).all()),
        f"extracted table mesh leaves the table box: "
        f"{obj_mesh.vertices.min(0)} .. {obj_mesh.vertices.max(0)}")
    scene_mesh = mesh_io.load_mesh(files["mesh"])
    tri = scene_mesh.vertices[scene_mesh.faces]
    picked_tri = np.array([any(np.allclose(np.sort(t, 0), np.sort(o, 0))
                               for o in obj_mesh.vertices[obj_mesh.faces])
                           for t in tri])
    check(int(picked_tri.sum()) == len(obj_mesh.faces),
          "extracted table mesh: not the scene mesh's triangles")
    xyz = ply_io.load_ply(files["ply"], device="cpu").xyz.numpy()
    nearest, d2 = closest_triangle(xyz, scene_mesh.vertices,
                                   scene_mesh.faces)
    span = scene_mesh.vertices.max(0) - scene_mesh.vertices.min(0)
    exact = d2 < (float(span.max()) / GRID_CELLS) ** 2
    row = np.dtype((np.void, 12))
    picked = ply_io.load_ply(os.path.join(base, "object_gaussians.ply"),
                             device="cpu").xyz.numpy()
    got = np.isin(np.ascontiguousarray(xyz).view(row)[:, 0],
                  np.ascontiguousarray(picked).view(row)[:, 0])
    check(int(got.sum()) == len(picked), "object_gaussians.ply: a splat "
          "that is not the scene's")
    split_off = int((got != picked_tri[nearest])[exact].sum())
    check(split_off <= SPLIT_TIES_MAX,
          f"object_gaussians.ply: {split_off} of the {int(exact.sum())} "
          f"splats within a grid cell of the mesh differ from the split by "
          f"nearest triangle (at most {SPLIT_TIES_MAX} ties wanted)")
    is_table = np.arange(len(xyz)) >= N_SPLATS  # merged after the scene
    hits = int((got & is_table).sum())
    share, recall = hits / max(len(picked), 1), hits / EDIT_TABLE_SPLATS
    check(share >= TABLE_SHARE_MIN and recall >= TABLE_RECALL_MIN,
          f"object_gaussians.ply: {share:.3f} of its splats are the table's "
          f"and {recall:.3f} of the table's are in it (at least "
          f"{TABLE_SHARE_MIN} and {TABLE_RECALL_MIN} wanted)")

    # physics: the cube fell onto the table top and rests there
    rb = scene.rb_transform[oid]
    z = np.array([rb[str(f)]["pos"][2] for f in range(N_CAMS)])
    xy = np.array(rb[str(N_CAMS - 1)]["pos"][:2])
    rest = TABLE_TOP + CUBE_HALF  # the cube's center resting on the top
    margin = solver.SolverConfig().collision_margin
    check(z[0] - z[-1] > 0.1, f"the cube did not fall: z {z}")
    check(z.min() >= rest - margin, f"the cube went into the table: z {z}")
    check(abs(z[-1] - rest) <= margin,
          f"the cube does not rest on the table top: z {z[-1]}, top "
          f"{rest} ± {margin}")
    check(min(np.abs(xy - land[:2]).max() for land in landings) <= 1e-3,
          f"the cube rests off its landing points: {xy}")

    # the anchor frame: the cube inside its projected silhouette; well
    # outside it, the background pass as the preamble rendered it,
    # darkened by the shadow ratio alone, and that ratio against a plain
    # slab test of the cube's box
    cam = index_camera(scene.cameras, anchor)
    pose = rb[str(anchor)]
    rot = euler_to_rotmat(*[float(x) for x in pose["rot"]]).numpy()
    world = corners @ rot.T + np.asarray(pose["pos"], np.float32)
    uv, depth = cam.project(torch.from_numpy(world.astype(np.float32))
                            .to(DEVICE))
    check(bool((depth > 0).all()), "the cube reaches behind camera 0")
    hull = convex_hull(uv.cpu().numpy().astype(np.float64))
    px = WIDTH / 1296.0
    core = in_polygon(hull, HEIGHT, WIDTH, -SILHOUETTE_INSET * px).to(DEVICE)
    near = in_polygon(hull, HEIGHT, WIDTH, SILHOUETTE_OUTSET * px).to(DEVICE)
    pre = png.read_png(os.path.join(cache, "traj", "images",
                                    f"{anchor:05d}.png"))
    pre = torch.from_numpy(pre.astype(np.float32) / 255.0).to(DEVICE)
    frame = frames[anchor]
    diff = (frame - pre).abs().amax(-1)
    bg, ratio, alpha = seen["bg"], seen["ratio"], seen["alpha"]
    bg_off = float((torch.clamp(bg, 0, 1) - pre).abs().max())
    check(bg_off <= PNG_TOL, f"anchor frame: the edit's background pass "
          f"differs from the preamble's PNG by up to {bg_off:.5f}")
    in_changed = float((diff[core] > 0.1).float().mean()) if bool(
        core.any()) else 0.0
    check(in_changed >= SILHOUETTE_CHANGED_MIN,
          f"anchor frame: {in_changed:.3f} of the {int(core.sum())} pixels "
          f"inside the cube's silhouette differ from the preamble by > 0.1 "
          f"(at least {SILHOUETTE_CHANGED_MIN} wanted)")
    outside = ~near
    out_share = float(outside.float().mean())
    r = torch.where((ratio - 1.0).abs() >= 0.01, ratio,
                    torch.ones_like(ratio))[..., None]
    a = torch.clamp(alpha, 0, 1)[..., None]
    want = torch.clamp(bg * r * a + bg * (1.0 - a), 0, 1)
    comp_off = float((frame - want).abs().amax(-1)[outside].max())
    lit = outside & (ratio >= 0.99)
    lit_off = float(diff[lit].max()) if bool(lit.any()) else 0.0
    check(out_share >= OUTSIDE_SHARE_MIN and comp_off <= COMPOSITE_TOL
          and lit_off <= PNG_TOL,
          f"anchor frame: {out_share:.3f} of the frame lies well outside the "
          f"cube (at least {OUTSIDE_SHARE_MIN} wanted); there it is off the "
          f"shadowed background by up to {comp_off:.2e} ({COMPOSITE_TOL} "
          f"allowed) and, where unshadowed, off the preamble by up to "
          f"{lit_off:.5f} ({PNG_TOL:.5f} allowed)")
    dirs, weights = scene._shadow_lights()
    pool = np.flatnonzero(outside.cpu().numpy())
    pick = torch.from_numpy(np.random.default_rng(14).choice(
        pool, min(SHADOW_SAMPLES, len(pool)), replace=False)).to(DEVICE)
    rays = cam.ray_directions().reshape(-1, 3)[pick]
    view_z = (seen["depth"] / torch.clamp(alpha, min=1e-6)).reshape(-1)[pick]
    pts = cam.center + rays * view_z[:, None] - 1e-2 * rays  # its bias
    rot_t = torch.from_numpy(rot).to(DEVICE, torch.float64)
    q = (pts.double() - torch.tensor(pose["pos"], dtype=torch.float64,
                                     device=DEVICE)) @ rot_t  # body frame
    dl = dirs.double() @ rot_t
    t1 = (-CUBE_HALF - q[:, None, :]) / dl[None]  # ±inf along a face
    t2 = (CUBE_HALF - q[:, None, :]) / dl[None]
    t_in = torch.minimum(t1, t2).nan_to_num(nan=-np.inf).amax(-1)
    t_out = torch.maximum(t1, t2).nan_to_num(nan=np.inf).amin(-1)
    hit = (t_in <= t_out) & (t_out > 0)
    plain = (weights.double() * ~hit).sum(-1) / weights.double().sum()
    shadow_err = (ratio.reshape(-1)[pick].double() - plain).abs()
    shadow_ok = float((shadow_err <= SHADOW_TOL).float().mean())
    check(shadow_ok >= SHADOW_SHARE_MIN,
          f"anchor frame: the shadow ratio matches a plain slab test on "
          f"{shadow_ok:.4f} of {len(pick)} pixels outside the cube (at "
          f"least {SHADOW_SHARE_MIN} wanted)")
    shaded = float((ratio[outside] < 0.99).float().mean())
    # the table top as camera 0 sees it: pixels whose point (the ray at
    # the background's depth) lies on the top inside its footprint
    flat = (cam.center + cam.ray_directions() * (seen["depth"] / torch.clamp(
        alpha, min=1e-6))[..., None]).reshape(-1, 3).cpu().numpy()
    n_top = int((inside_table(flat, 0.0)
                 & (np.abs(flat[:, 2] - TABLE_TOP) < 0.02)).sum())
    changed = int((diff > 0.1).sum())
    changed_near = int(((diff > 0.1) & near).sum())

    # kernels 1-3 once per render, and every render on a stage
    check_launches(launches, {"preprocess": clock.renders,
                              "duplicate_with_keys": clock.renders,
                              "blend_fwd": clock.renders}, "edit program")
    check(sum(v["renders"] for v in st.values()) == clock.renders,
          f"edit program: {clock.renders} renders, "
          f"{sum(v['renders'] for v in st.values())} of them on a stage")
    check(st["preamble"]["renders"] == N_CAMS
          and st["render_scene"]["renders"] == 2 * N_CAMS
          and st["detect+extract"]["renders"] > 0
          and st["physics"]["renders"] == 0, "edit program: renders a stage")

    # one background pass and one object pass against the plain versions
    err = {}
    rng = np.random.default_rng(13)
    captured = []

    def capture(g, c, bg=None):
        captured.append(g)
        return scene_cls.rasterize(scene, g, c, bg)

    scene.rasterize = capture
    scene.render_object_pass(anchor)
    del scene.rasterize
    for what, g in (("background", scene.gaussians), ("object", captured[0])):
        for k, e in check_view_kernels(P, g, cam, budget, EDIT_TILE, rng,
                                       f"edit program {what} pass").items():
            err[k] = max(err.get(k, 0.0), e)
    print(f"edit program: anchor frame {changed} pixels differ from the "
          f"preamble by > 0.1, {changed_near} of them within "
          f"{SILHOUETTE_OUTSET * px:.0f} px of the cube's silhouette; "
          f"{in_changed:.3f} of the {int(core.sum())} inside it; "
          f"{out_share:.3f} of the frame well outside it, {shaded:.3f} of "
          f"that shadowed (ratio < 0.99), the composite there within "
          f"{comp_off:.2e} of the shadowed background and the unshadowed "
          f"within {lit_off:.5f} of the preamble; the background pass "
          f"within {bg_off:.5f} of the preamble; the shadow ratio against "
          f"the slab test on {shadow_ok:.4f} of {len(pick)} pixels "
          f"(worst {float(shadow_err.max()):.2e}); {n_top} pixels see the "
          f"table top; the cube's z " + ", ".join(f"{x:.4f}" for x in z)
          + f" (rests at {rest} ± {margin}) at {xy}; the extracted table: "
          f"{len(obj_mesh.faces)} triangles, object_gaussians.ply "
          f"{len(picked)} splats ({split_off} of {int(exact.sum())} near the "
          f"mesh off the brute-force split), {hits} of them the table's "
          f"({share:.3f}; {recall:.3f} of the table's {EDIT_TABLE_SPLATS}); "
          f"launches {launches} for {clock.renders} renders; "
          f"the background and object passes' kernels against their plain "
          f"versions ({CHECK_TILES} tiles each): ok")

    # times
    stage_txt = ", ".join(
        f"{k} {v['s'] * 1000.0:.1f} ms ({v['renders']} renders)"
        for k, v in st.items())
    print(f"[{card}] edit program at {scene.gaussians.capacity} splats {WIDTH}x{HEIGHT} "
          f"tile {EDIT_TILE}, {N_CAMS} frames: run_scene_editing "
          f"{wall * 1000.0:.1f} ms wall; stages (wall): {stage_txt}; "
          f"render_scene {st['render_scene']['s'] * 1000.0 / N_CAMS:.1f} ms "
          f"a frame; peak device memory {peak / 2**30:.2f} GiB")

    def frame():
        c, d, a = scene.render_from_3DGS(frame_indices=[anchor])
        return scene.render_frame(anchor, c[0], d[0], a[0])

    for _ in range(WARMUP):
        frame()
    sync()
    streamed = cuda_ms(frame, 5)
    records = profiled(frame, 1)
    busy = sum(e.duration_ns() for e in records) / 1e6
    print(f"[{card}] edit program frame (background pass + render_frame): "
          f"{streamed:.3f} ms (CUDA events), device busy {busy:.3f} ms, idle "
          f"share {1.0 - busy / streamed:.3f}, {len(records)} device records")
    c, d, a = (x[0] for x in scene.render_from_3DGS(frame_indices=[anchor]))
    parts = {
        "background pass": lambda: scene.render_from_3DGS(
            frame_indices=[anchor]),
        "object pass": lambda: scene.render_object_pass(anchor),
        "shadow pass": lambda: scene.render_shadow_pass(anchor, d, a),
    }
    part_ms = {k: device_ms(fn, KERNEL_REPS, max_lost=1)
               for k, fn in parts.items()}
    print(f"[{card}] edit program frame by pass (device ms, profiler): "
          + ", ".join(f"{k} {v:.3f}" for k, v in part_ms.items())
          + f"; the rest (composite) {busy - sum(part_ms.values()):.3f}")
    tmp.cleanup()
    return launches, err


# ---- the removal program ---------------------------------------------------------


def icosphere() -> tuple[np.ndarray, np.ndarray]:
    """A once-subdivided icosphere of unit diameter (42 vertices, 80
    faces): every vertex stays in the solver's 64-vertex hull, so the
    hull the ball rests on is its mesh."""
    p = (1 + 5 ** 0.5) / 2
    v = [np.array(x, float) for x in (
        (-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0), (0, -1, p), (0, 1, p),
        (0, -1, -p), (0, 1, -p), (p, 0, -1), (p, 0, 1), (-p, 0, -1),
        (-p, 0, 1))]
    v = [x / np.linalg.norm(x) for x in v]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5),
             (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    mid, out = {}, []

    def m(a, b):
        key = (min(a, b), max(a, b))
        if key not in mid:
            c = v[a] + v[b]
            v.append(c / np.linalg.norm(c))
            mid[key] = len(v) - 1
        return mid[key]

    for a, b, c in faces:
        ab, bc, ca = m(a, b), m(b, c), m(c, a)
        out += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
    return (0.5 * np.array(v)).astype(np.float32), np.array(out, np.int64)


def removal_program_files(P, root: str) -> dict:
    """The removal program's inputs under ``root``: the edit program's
    scene, trajectory and table masks (``edit_program_files``), a local
    asset library of a basketball (``icosphere``) and two distractors,
    big-lama's widths as a seeded checkpoint, and the program."""
    from autovfx_tpu_torch.edit import mesh_io
    from autovfx_tpu_torch.utils.synthetic import lama_state_dict

    files = edit_program_files(P, root)
    t0 = time.perf_counter()
    lib = os.path.join(root, "assets")
    os.makedirs(lib)
    v, f = icosphere()
    color = lambda n, rgb: np.tile(np.asarray(rgb, np.float32), (n, 1))
    mesh_io.save_obj(os.path.join(lib, "basketball.obj"), mesh_io.Mesh(
        v, f, vertex_colors=color(len(v), (0.85, 0.4, 0.1))))
    corners = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                        for z in (-0.5, 0.5)], np.float32)
    mesh_io.save_obj(os.path.join(lib, "red_cube.obj"), mesh_io.Mesh(
        corners, CUBE_FACES, vertex_colors=color(8, (0.8, 0.1, 0.1))))
    seat = corners * [0.5, 0.5, 0.1]
    back = corners * [0.5, 0.08, 0.5] + [0.0, 0.21, 0.3]
    mesh_io.save_obj(os.path.join(lib, "chair.obj"), mesh_io.Mesh(
        np.concatenate([seat, back]),
        np.concatenate([CUBE_FACES, CUBE_FACES + 8]),
        vertex_colors=color(16, (0.5, 0.3, 0.2))))
    ckpt = os.path.join(root, "big-lama.ckpt")
    torch.save({"state_dict": lama_state_dict(**LAMA_WIDTHS, seed=0)}, ckpt)
    program = os.path.join(root, "removal_program.py")
    dx, dy = BALL_AWAY * table_frame()[1]
    with open(program, "w") as fh:
        fh.write('table = detect_object(scene, "table")\n'
                 "drop_pos = get_object_bottom_position(table) + np.array("
                 f"[{dx:.4f}, {dy:.4f}, {BALL_DROP}], np.float32)\n"
                 "remove_object(scene, table)\n"
                 'ball = retrieve_asset(scene, "basketball")\n'
                 "ball = translate_object(ball, drop_pos - "
                 "get_object_bottom_position(ball))\n"
                 "ball = allow_physics(ball)\n"
                 "insert_object(scene, ball)\n")
    print(f"removal program inputs: the asset library {sorted(os.listdir(lib))}"
          f", a big-lama-shaped checkpoint ({LAMA_WIDTHS}, seed 0) of "
          f"{os.path.getsize(ckpt) / 2**20:.1f} MiB, in "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(files, lib=lib, ckpt=ckpt, program=program)


def in_convex(points: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Which 2-D ``points`` lie inside the convex polygon ``ring`` (its
    vertices in order, either way round)."""
    d = np.roll(ring, -1, 0) - ring
    rel = points[:, None, :] - ring[None]
    cross = d[None, :, 0] * rel[..., 1] - d[None, :, 1] * rel[..., 0]
    return (cross >= 0).all(1) | (cross <= 0).all(1)


def removal_program_point(P, card: str) -> tuple[dict, dict]:
    """The port's edit entry on the edit program's scene with a removal
    program at full width: the table is detected, removed (the removal
    renders, LaMa on each view, the retraining on the inpainted views,
    the scene reloaded) and a basketball retrieved from a local library
    (its previews rendered) and dropped where the table stood; physics
    and ``render_scene`` over the 8 ring views.  Each stage is timed and
    its renders counted, the kernels' launches counted over the run;
    then its results are checked."""
    import random

    from autovfx_tpu_torch import bench, edit_scene
    from autovfx_tpu_torch.core import ply_io
    from autovfx_tpu_torch.core.cameras import index_camera
    from autovfx_tpu_torch.core.quaternion import euler_to_rotmat
    from autovfx_tpu_torch.edit import edit_utils, mesh_io
    from autovfx_tpu_torch.edit import scene_representation as SR
    from autovfx_tpu_torch.gpt import lmp
    from autovfx_tpu_torch.perception import extract, lama
    from autovfx_tpu_torch.physics import solver
    from autovfx_tpu_torch.render import preview
    from autovfx_tpu_torch.train import inpaint_retrain, trainer
    from autovfx_tpu_torch.utils import png

    ops = P.ops
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    files = removal_program_files(P, root)
    # the budget: the worst ring view of the whole scene, with room for
    # the retraining's densification to fill its 1.5x capacity, or of
    # the ball's 60,000 surfels resting where the table stood
    from autovfx_tpu_torch.render import meshsplat

    need = lambda x, c: int(ops.binning.required_budget(
        ops.preprocess_cuda.preprocess(x, c, tile=EDIT_TILE)))
    g = ply_io.load_ply(files["ply"], device=DEVICE)
    ring = bench.ring_cameras(WIDTH, HEIGHT, N_CAMS, DEVICE)
    worst = max(need(g, c) for c in ring)
    v, f = icosphere()
    center, ahead, _ = table_frame()
    center = np.append(center + BALL_AWAY * ahead, BALL_SIZE / 2)
    surf = meshsplat.sample_mesh_surfels(
        mesh_io.Mesh(v, f).normalized_to_unit_box().vertices * BALL_SIZE
        + center, f, 60_000, device=DEVICE)
    ball_g = meshsplat.surfels_to_gaussians(
        surf["points"], surf["normals"], surf["colors"], surf["radius"])
    worst_ball = max(need(ball_g, c) for c in ring)
    budget = ops.binning.round_budget(max(1.5 * worst, worst_ball),
                                      slack=BUDGET_SLACK)
    del g, surf, ball_g
    print(f"removal program duplicates: worst view {worst} (the ball's "
          f"{worst_ball}), budget {budget}")
    opts = edit_scene.get_opts([
        "--source_path", root, "--model_path", root,
        "--gaussians_ckpt_path", files["ply"],
        "--scene_mesh_path", files["mesh"], "--custom_traj_name", "ring",
        "--dup_budget", str(budget), "--edit_text",
        "Remove the table and drop a basketball where it stood.",
        "--offline_program", files["program"], "--device", DEVICE])

    clock = StageClock()
    seen = {"lama_in": [], "lama_out": [], "psnr": [], "overflow": [],
            "lpips_steps": 0, "densify": [], "retrievals": []}
    scene_cls = SR.SceneRepresentation
    wrapped = [(scene_cls, k) for k in (
        "rasterize", "render_from_3DGS", "load_scene", "run_physics",
        "render_scene")]
    wrapped += [(edit_utils, k) for k in ("detect_object", "remove_object",
                                          "retrieve_asset")]
    wrapped += [(extract, "inpaint_object"), (extract, "inpaint_img_with_lama"),
                (lama, "lama_generator"),
                (inpaint_retrain, "training_3DGS_for_inpainting"),
                (inpaint_retrain, "inpaint_step"),
                (inpaint_retrain, "rasterize"), (preview, "rasterize"),
                (trainer, "densify_step"), (lmp.LMP, "__call__")]
    saved = [(owner, k, getattr(owner, k)) for owner, k in wrapped]

    def counted(owner, attr):
        fn = getattr(owner, attr)

        def render(*a, **k):
            clock.renders += 1
            return fn(*a, **k)

        setattr(owner, attr, render)

    def keep_scene(_, self, *a, **k):
        seen["scene"] = self

    def keep_lama_in(out, rgb, hole, **k):
        seen["lama_in"].append(((np.clip(rgb, 0, 1) * 255).astype(np.uint8),
                                np.asarray(hole, bool)))

    def keep_lama_out(y, *a, **k):
        seen["lama_out"].append((bool(torch.isfinite(y).all()),
                                 y.min().item(), y.max().item()))

    def keep_step(result, state, cam, img, mask, cfg, use_lpips):
        state, aux = result
        seen["psnr"].append(aux.psnr)
        seen["overflow"].append(aux.overflow)
        seen["lpips_steps"] += bool(use_lpips)
        seen["state"] = state
        if state.step == RETRAIN_CHECK_STEP:
            g = state.gaussians
            seen["check"] = (dataclasses.replace(g, **{
                f.name: getattr(g, f.name).clone()
                for f in dataclasses.fields(g)}), cam)

    def keep_densify(result, state, *a, **k):
        res = result[1]
        seen["densify"].append((int(state.gaussians.num_active),
                                int(res.gaussians.num_active),
                                {n: int(getattr(res, n)) for n in (
                                    "n_cloned", "n_split", "n_pruned",
                                    "dropped")}))

    for owner, attr in ((scene_cls, "rasterize"), (inpaint_retrain,
                                                   "rasterize"),
                        (preview, "rasterize")):
        counted(owner, attr)
    clock.wrap(scene_cls, "render_from_3DGS",
               lambda n: "preamble" if n == 0 else None)
    clock.wrap(scene_cls, "load_scene", lambda n: "reload" if n else None)
    clock.wrap(scene_cls, "run_physics", "physics")
    clock.wrap(scene_cls, "render_scene", "render_scene", keep=keep_scene)
    clock.wrap(edit_utils, "detect_object", "detect+extract")
    clock.wrap(edit_utils, "remove_object", "remove")
    clock.wrap(edit_utils, "retrieve_asset", "retrieval+previews",
               keep=lambda out, *a, **k: seen["retrievals"].append(out))
    clock.wrap(extract, "inpaint_object", "inpaint")
    clock.wrap(extract, "inpaint_img_with_lama", lambda n: None,
               keep=keep_lama_in)
    clock.wrap(lama, "lama_generator", "lama", keep=keep_lama_out)
    clock.wrap(inpaint_retrain, "training_3DGS_for_inpainting", "retraining")
    clock.wrap(inpaint_retrain, "inpaint_step", lambda n: None, keep=keep_step)
    clock.wrap(trainer, "densify_step", lambda n: None, keep=keep_densify)
    clock.wrap(lmp.LMP, "__call__", "program")
    env = {"AUTOVFX_ASSET_DIR": files["lib"],
           "AUTOVFX_LAMA_CKPT": files["ckpt"]}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    random.seed(0)
    np.random.seed(0)
    torch.cuda.reset_peak_memory_stats()
    sync()
    P.utils.trace.reset()
    t0 = time.perf_counter()
    try:
        frames = edit_scene.run_scene_editing(opts, opts.edit_text,
                                              opts.offline_program)
        sync()
    finally:
        for owner, k, fn in saved:
            setattr(owner, k, fn)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    launches = bench.kernel_launches()
    fields = field_launches()
    peak = torch.cuda.max_memory_allocated()
    st = clock.stages
    for outer, inner in (("program", "detect+extract"), ("program", "remove"),
                         ("program", "retrieval+previews"),
                         ("remove", "inpaint"), ("remove", "retraining"),
                         ("remove", "reload"), ("inpaint", "lama"),
                         ("render_scene", "physics")):
        clock.exclusive(outer, inner)
    scene = seen["scene"]
    anchor = scene.hparams.anchor_frame_idx
    cache = os.path.join(root, "cache")
    base = os.path.join(cache, "extract", "table", "1")

    # the frames
    check(tuple(frames.shape) == (N_CAMS, HEIGHT, WIDTH, 3),
          f"removal program frames: shape {tuple(frames.shape)}")
    check(bool(torch.isfinite(frames).all()) and frames.min().item() >= 0.0
          and frames.max().item() <= 1.0,
          "removal program frames: not finite or outside [0, 1]")
    check(not bool(scene.overflowed), "removal program: duplicate overflow")

    # LaMa on every view: finite, in [0, 1], and the inpainted PNG equal
    # to the removal render outside the hole
    n_views = len(seen["lama_in"])
    check(n_views == N_CAMS and len(seen["lama_out"]) == N_CAMS,
          f"LaMa ran on {len(seen['lama_out'])} of {N_CAMS} views")
    lo = min(x[1] for x in seen["lama_out"])
    hi = max(x[2] for x in seen["lama_out"])
    check(all(x[0] for x in seen["lama_out"]) and lo >= 0.0 and hi <= 1.0,
          f"LaMa's output: finite {[x[0] for x in seen['lama_out']]}, range "
          f"[{lo}, {hi}]")
    holes = []
    for i, (want, hole) in enumerate(seen["lama_in"]):
        got = png.read_png(os.path.join(base, "render_inpaint_lama",
                                        f"{i:05d}.png"))
        mask = png.read_mask(os.path.join(base, "render_inpaint_mask",
                                          f"{i:05d}.png"))
        check(np.array_equal(mask, hole), f"view {i}: the hole PNG differs")
        check(np.array_equal(got[~hole], want[~hole]),
              f"view {i}: the inpainted PNG differs from the removal render "
              f"outside the hole at {int((got[~hole] != want[~hole]).sum())} "
              "values")
        holes.append(int(hole.sum()))

    # the retraining: every iteration, finite, no overflow, densify's
    # counts, the PSNR against the inpainted targets rising
    steps = len(seen["psnr"])
    check(steps == RETRAIN_ITERATIONS,
          f"the retraining ran {steps} of {RETRAIN_ITERATIONS} iterations")
    check_state(seen["state"], "after the retraining")
    check(not bool(torch.stack(seen["overflow"]).any()),
          "the retraining: a step overflowed its duplicate budget")
    for n_before, n_after, c in seen["densify"]:
        expect = (n_before + c["n_cloned"] + 2 * c["n_split"] - c["n_pruned"]
                  - c["dropped"])
        check(n_after == expect, f"densify: {n_before} -> {n_after}, {c}")
    check(len(seen["densify"]) == (RETRAIN_ITERATIONS - 1) // 300,
          f"{len(seen['densify'])} densifications")
    psnrs = torch.stack(seen["psnr"]).cpu().numpy()
    first, last = (float(psnrs[:PSNR_STEPS].mean()),
                   float(psnrs[-PSNR_STEPS:].mean()))
    check(np.isfinite(psnrs).all() and last > first,
          f"the retraining's PSNR against the inpainted views: {first:.3f} "
          f"dB over the first {PSNR_STEPS} steps, {last:.3f} over the last")
    # kernel 4 and the preprocess backward at one step, on its shapes
    rng = np.random.default_rng(15)
    g_k, cam_k = seen["check"]
    tx, ty = ops.projection.num_tiles(WIDTH, HEIGHT, EDIT_TILE)
    tiles = torch.from_numpy(rng.choice(tx * ty, CHECK_TILES,
                                        replace=False)).to(DEVICE)
    what = f"retraining step {RETRAIN_CHECK_STEP} ({g_k.capacity} slots)"
    e1, r1 = check_preprocess_bwd(P, g_k, cam_k, EDIT_TILE, rng, what)
    e2, r2, zeroed, n_px = check_blend_bwd(P, g_k, cam_k, EDIT_TILE, rng,
                                           what, tiles=tiles)
    err = {"preprocess_bwd": e1, "blend_bwd": e2}
    # the LPIPS step at full width: the bench scene's far shell covers
    # every ray, so the removal renders may leave no hole and no step
    # take LPIPS (none did on an H100); it is timed here on camera 0 with
    # the table's mask as its hole, beside the step without it, from the
    # state of that step
    table_mask = torch.from_numpy(png.read_mask(os.path.join(
        cache, "tracking", "table", "1", f"{anchor:05d}.png"))).to(DEVICE)
    target = torch.from_numpy(png.read_png(os.path.join(
        base, "render_inpaint_lama", f"{anchor:05d}.png")).astype(
        np.float32) / 255.0).to(DEVICE)
    cfg = inpaint_retrain.inpaint_config(scene, RETRAIN_ITERATIONS)
    cam0 = index_camera(scene.cameras, anchor)
    box = [trainer.init_state(g_k)]

    def lpips_step(use_lpips):
        box[0], aux = inpaint_retrain.inpaint_step(box[0], cam0, target,
                                                   table_mask, cfg, use_lpips)
        return aux

    aux = lpips_step(True)
    check(bool(torch.isfinite(aux.loss)) and not bool(aux.overflow),
          f"the LPIPS step at full width: loss {aux.loss.item()}")
    step_ms = {k: cuda_ms(lambda k=k: lpips_step(k), 5) for k in (True,
                                                                   False)}
    check_state(box[0], "after the LPIPS steps")
    del seen["check"], seen["state"], box

    # the scene swap: the retrained splats, the removal mesh + the patch
    ply = os.path.join(base, "inpaint_gaussians.ply")
    check(scene.hparams.gaussians_ckpt_path == ply
          and scene.gaussians.capacity
          == ply_io.load_ply(ply, device="cpu").capacity,
          "the reloaded scene is not inpaint_gaussians.ply")
    merged = mesh_io.load_mesh(scene.scene_mesh_path_for_blender)
    removal = mesh_io.load_mesh(os.path.join(base, "removal_mesh",
                                             "removal_mesh.obj"))
    n_patch = len(merged.vertices) - len(removal.vertices) - 1
    check(scene.scene_mesh_path_for_blender.endswith(
        "inpaint_removal_mesh.obj") and n_patch >= 3
        and len(merged.faces) == len(removal.faces) + n_patch,
        f"the scene mesh: {len(merged.faces)} faces, the removal mesh "
        f"{len(removal.faces)}, a patch of {n_patch} triangles")
    patch = merged.vertices[len(removal.vertices):]
    patch_z = float(patch[0, 2])

    # the table is gone: inside camera 0's table mask the anchor frame
    # differs from the preamble's render, which shows the table
    pre = png.read_png(os.path.join(cache, "traj", "images",
                                    f"{anchor:05d}.png"))
    pre = torch.from_numpy(pre.astype(np.float32) / 255.0).to(DEVICE)
    diff = (frames[anchor] - pre).abs().amax(-1)
    gone = float((diff[table_mask] > TABLE_GONE_DIFF).float().mean())
    check(gone >= TABLE_GONE_SHARE,
          f"the table: {gone:.3f} of camera {anchor}'s {int(table_mask.sum())}"
          f" table pixels differ from the preamble by > {TABLE_GONE_DIFF} "
          f"(at least {TABLE_GONE_SHARE} wanted)")

    # retrieval: the basketball, at the size table's scale, its previews
    check(len(seen["retrievals"]) == 1, "retrieve_asset: not called once")
    ball = seen["retrievals"][0]
    check(ball["object_id"] == "basketball"
          and abs(ball["scale"] - BALL_SIZE / scene.scene_scale) < 1e-9,
          f"retrieve_asset: {ball['object_id']} at scale {ball['scale']}")
    pv_dir = os.path.join(cache, "assets_rendering_multi_views", "basketball")
    names = sorted(os.listdir(pv_dir))
    pv_pixels = [int((png.read_png(os.path.join(pv_dir, n)).min(-1) < 250)
                     .sum()) for n in names]
    check(len(names) == 4 and min(pv_pixels) >= PREVIEW_PIXELS_MIN,
          f"previews {names}: {pv_pixels} object pixels (at least "
          f"{PREVIEW_PIXELS_MIN} each wanted)")
    cam_p, g_p = preview.preview_views(ball["object_path"], 4, 256,
                                       device=DEVICE)[0]
    for k, e in check_view_kernels(P, g_p, cam_p,
                                   preview.PREVIEW_CONFIG.dup_budget,
                                   preview.PREVIEW_CONFIG.tile, rng,
                                   "preview 0").items():
        err[k] = max(err.get(k, 0.0), e)

    # the ball lands: it fell, is at rest over the last frames, and its
    # lowest point lies on the patch's plane inside the patch
    margin = solver.SolverConfig().collision_margin
    oid = ball["object_id"]
    rb = scene.rb_transform[oid]
    z = np.array([rb[str(f)]["pos"][2] for f in range(N_CAMS)])
    pose = rb[str(N_CAMS - 1)]
    rot = euler_to_rotmat(*[float(x) for x in pose["rot"]]).numpy()
    verts = mesh_io.load_mesh(ball["object_path"]).normalized_to_unit_box()
    world = (verts.vertices * float(pose["scale"][0])) @ rot.T + pose["pos"]
    low = world[np.argmin(world[:, 2])]
    rest = float(np.abs(z[-REST_FRAMES:] - z[-1]).max())
    check(z[0] - z[-1] > 0.01 and rest <= margin,
          f"the ball does not come to rest: z {z}")
    check(-BALL_SINK_MAX <= low[2] - patch_z <= margin
          and bool(in_convex(low[None, :2], patch[1:, :2])[0]),
          f"the ball's lowest point {low} is not on the patch (z {patch_z}, "
          f"within -{BALL_SINK_MAX}..{margin})")

    # the launches: kernels 1-3 once a render, 4 and the preprocess
    # backward once a retraining step, kernel 3's training variant there
    fwd = launches["blend_fwd"] + launches["blend_fwd_train"]
    check(launches["preprocess"] == launches["duplicate_with_keys"] == fwd
          == clock.renders and launches["blend_fwd_train"]
          == launches["blend_bwd"] == launches["preprocess_bwd"] == steps,
          f"removal program: launches {launches} for {clock.renders} renders "
          f"and {steps} steps")
    check(sum(v["renders"] for v in st.values()) == clock.renders,
          f"removal program: {clock.renders} renders, "
          f"{sum(v['renders'] for v in st.values())} of them on a stage")
    check(st["preamble"]["renders"] == N_CAMS
          and st["inpaint"]["renders"] == N_CAMS
          and st["retraining"]["renders"] == steps
          and st["retrieval+previews"]["renders"] == 4,
          "removal program: renders a stage")
    large = seen["lpips_steps"]
    print(f"removal program: LaMa on {n_views} views (output in [{lo:.4f}, "
          f"{hi:.4f}], holes of {holes} pixels); the inpainted PNGs equal "
          f"the removal renders outside the holes; retraining {steps} "
          f"iterations ({large} of them with LPIPS, on views with large "
          f"holes), PSNR {first:.3f} -> {last:.3f} dB (first and last "
          f"{PSNR_STEPS} steps), densify {seen['densify']}; at step "
          f"{RETRAIN_CHECK_STEP} preprocess_bwd and blend_bwd ({CHECK_TILES} "
          f"tiles, {zeroed} of {n_px} pixels zeroed) against the plain "
          f"versions: max abs err {e1:.3g}, {e2:.3g} ({r1:.3g}, {r2:.3g} of "
          f"the largest); the scene reloaded from inpaint_gaussians.ply "
          f"({scene.gaussians.capacity} splats), its mesh "
          f"{len(removal.faces)} + {n_patch} patch triangles; {gone:.3f} of "
          f"camera {anchor}'s table pixels changed; the basketball at scale "
          f"{ball['scale']}, previews of {pv_pixels} object pixels, preview "
          f"0's kernels against the plain versions: ok; the ball's z "
          + ", ".join(f"{x:.4f}" for x in z) + f", its lowest point {low} "
          f"on the patch at z {patch_z}; launches {launches} for "
          f"{clock.renders} renders")

    # times
    stage_txt = ", ".join(
        f"{k} {v['s'] * 1000.0:.1f} ms ({v['renders']} renders)"
        for k, v in st.items())
    print(f"[{card}] removal program at {WIDTH}x{HEIGHT} tile {EDIT_TILE}, "
          f"{N_CAMS} frames: run_scene_editing {wall * 1000.0:.1f} ms wall; "
          f"stages (wall, each without the stages inside it): {stage_txt}; "
          f"a retraining step {st['retraining']['s'] * 1000.0 / steps:.2f} "
          f"ms, LaMa {st['lama']['s'] * 1000.0 / n_views:.1f} ms a view; "
          f"a step on camera {anchor} with the table's mask as its hole "
          f"{step_ms[True]:.2f} ms with LPIPS, {step_ms[False]:.2f} ms "
          f"without (CUDA events, 5 calls); "
          f"peak device memory {peak / 2**30:.2f} GiB")

    def frame():
        c, d, a = scene.render_from_3DGS(frame_indices=[anchor])
        return scene.render_frame(anchor, c[0], d[0], a[0])

    for _ in range(WARMUP):
        frame()
    sync()
    streamed = cuda_ms(frame, 5)
    records = profiled(frame, 1)
    busy = sum(e.duration_ns() for e in records) / 1e6
    print(f"[{card}] removal program frame (background pass + render_frame):"
          f" {streamed:.3f} ms (CUDA events), device busy {busy:.3f} ms, idle "
          f"share {1.0 - busy / streamed:.3f}, {len(records)} device records")
    c, d, a = (x[0] for x in scene.render_from_3DGS(frame_indices=[anchor]))
    parts = {
        "background pass": lambda: scene.render_from_3DGS(
            frame_indices=[anchor]),
        "object pass": lambda: scene.render_object_pass(anchor),
        "shadow pass": lambda: scene.render_shadow_pass(anchor, d, a),
    }
    part_ms = {k: device_ms(fn, KERNEL_REPS, max_lost=1)
               for k, fn in parts.items()}
    print(f"[{card}] removal program frame by pass (device ms, profiler): "
          + ", ".join(f"{k} {v:.3f}" for k, v in part_ms.items())
          + f"; the rest (composite) {busy - sum(part_ms.values()):.3f}")
    tmp.cleanup()
    launches["blend_fwd"] = fwd
    del launches["blend_fwd_train"]
    return launches, err


# ---- the SuGaR pipeline --------------------------------------------------------

COLMAP_POINT = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                         ("error", "<f8"), ("track", "<u8")])
SH_C0 = 0.28209479177387814


def write_colmap_model(sparse: str, cams, xyz: np.ndarray,
                       rgb8: np.ndarray) -> None:
    """A COLMAP binary model in ``sparse``: one PINHOLE camera with the
    first camera's intrinsics, an image ``view_<i>.png`` at each camera's
    pose, and the points (``rgb8`` uint8) with empty tracks."""
    from autovfx_tpu_torch.core.quaternion import rotmat_to_quat
    from autovfx_tpu_torch.dataset.colmap import qvec_to_rotmat

    os.makedirs(sparse, exist_ok=True)
    c0 = cams[0]
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, c0.width, c0.height))
        f.write(struct.pack("<4d", *(float(x) for x in (c0.fx, c0.fy, c0.cx,
                                                        c0.cy))))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, cam in enumerate(cams):
            R = cam.R.double().cpu()
            q = rotmat_to_quat(R).numpy()
            check(np.abs(qvec_to_rotmat(q) - R.numpy()).max() < 1e-6,
                  f"camera {i}: the quaternion does not give its rotation")
            f.write(struct.pack("<i4d3di", i + 1, *q,
                                *cam.t.double().cpu().numpy(), 1))
            f.write(f"view_{i}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    rec = np.zeros(len(xyz), COLMAP_POINT)
    rec["id"] = np.arange(len(xyz))
    rec["xyz"] = xyz
    rec["rgb"] = rgb8
    rec["error"] = 0.5
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)) + rec.tobytes())


def sugar_scene_files(P, root: str) -> int:
    """A COLMAP scene under ``root`` (``sparse/0`` and ``images/``): one
    PINHOLE camera with the ring's intrinsics at 1296×840, the ring's 8
    poses, the 1M centres of the garden-like scene (seed 0) with their
    SH-DC colours as the SfM points, and the 8 views rendered by the port
    at tile 16 as PNGs.  Returns the CLI's duplicate budget: the worst
    ring view of the scene and of the Gaussians the CLI starts from, with
    the training point's headroom."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.train.trainer import init_gaussians_from_points
    from autovfx_tpu_torch.utils import png
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    ops = P.ops
    t0 = time.perf_counter()
    g = make_garden_like(N_SPLATS, seed=0, extent=EXTENT, device=DEVICE)
    cams = bench.ring_cameras(WIDTH, HEIGHT, N_CAMS, DEVICE)
    rgb = torch.clamp(g.sh_dc * SH_C0 + 0.5, 0.0, 1.0)
    rgb8 = torch.round(rgb * 255.0).to(torch.uint8)
    start = init_gaussians_from_points(g.xyz, rgb8.float() / 255.0)
    need = lambda x, c: int(ops.binning.required_budget(
        ops.preprocess_cuda.preprocess(x, c, tile=SUGAR_TILE)))
    worst = max(need(x, c) for x in (g, start) for c in cams)
    budget = ops.binning.round_budget(worst, slack=BUDGET_SLACK * 1.25)
    del start

    images = os.path.join(root, "images")
    os.makedirs(images)
    write_colmap_model(os.path.join(root, "sparse", "0"), cams,
                       g.xyz.cpu().numpy(), rgb8.cpu().numpy())
    config = P.RasterConfig(dup_budget=budget, tile=SUGAR_TILE)
    with torch.no_grad():
        for i, cam in enumerate(cams):
            out = P.rasterize(g, cam, config=config)
            check(not bool(out.overflow), f"view {i}: overflow")
            png.write_png(os.path.join(images, f"view_{i}.png"),
                          (torch.clamp(out.color, 0, 1) * 255.0).to(
                              torch.uint8).cpu().numpy())
    print(f"SuGaR scene: {N_SPLATS} SfM points and {len(cams)} views at "
          f"{WIDTH}x{HEIGHT} written as a COLMAP model in "
          f"{time.perf_counter() - t0:.1f} s; duplicates: worst view {worst} "
          f"(of the scene and of the CLI's start), budget {budget}")
    return budget


def rms_to_levelset(P, g, verts: np.ndarray, level: float) -> float:
    """bench.py:602-613's statistic: the RMS of |clip(density, 0, 1) −
    level| at the vertices (every n-th, at most ``RMS_VERTICES``)."""
    from autovfx_tpu_torch.sugar import density as D
    from autovfx_tpu_torch.sugar.levelset import _nearest_gaussian

    sel = torch.as_tensor(np.asarray(verts, np.float32)[
        ::max(-(-len(verts) // RMS_VERTICES), 1)], device=DEVICE)
    with torch.no_grad():
        nbrs = D.reset_neighbors(g, k=16)[_nearest_gaussian(sel, g)]
        dens = D.compute_density(sel, nbrs, g).cpu().numpy()
    return float(np.sqrt(np.mean((np.clip(dens, 0, 1) - level) ** 2))), len(sel)


def counted_renders(clock: StageClock, owners) -> list:
    """Count each call of ``owner.rasterize`` (the forward renders) in
    ``clock.renders``; returns the ``(owner, attr, fn)`` to restore."""
    saved = []
    for owner in owners:
        fn = owner.rasterize
        saved.append((owner, "rasterize", fn))

        def render(*a, fn=fn, **k):
            clock.renders += 1
            return fn(*a, **k)

        owner.rasterize = render
    return saved


def capture_backward(P, step) -> dict:
    """The inputs of every kernel-4 and preprocess-backward launch of one
    ``step()``; the Gaussians and the splat gradients cloned (Adam
    updates the Gaussians in place after the backward)."""
    ops = P.ops
    calls = {"blend_bwd": [], "preprocess_bwd": []}
    real_b = ops.blend_cuda.blend_bwd_kernel
    real_p = ops.preprocess_cuda.preprocess_bwd_kernel

    def blend_bwd(*a):
        calls["blend_bwd"].append(a)
        return real_b(*a)

    def preprocess_bwd(g, cam, tiles_touched, d, *a):
        clone = lambda x: dataclasses.replace(x, **{
            f.name: getattr(x, f.name).clone() for f in dataclasses.fields(x)})
        calls["preprocess_bwd"].append(
            (clone(g), cam, tiles_touched,
             type(d)(*(x.clone() for x in d)), *a))
        return real_p(g, cam, tiles_touched, d, *a)

    ops.blend_cuda.blend_bwd_kernel = blend_bwd
    ops.preprocess_cuda.preprocess_bwd_kernel = preprocess_bwd
    try:
        step()
        sync()
    finally:
        ops.blend_cuda.blend_bwd_kernel = real_b
        ops.preprocess_cuda.preprocess_bwd_kernel = real_p
    return calls


def cotangent_tiles(P, grads, w: int, h: int, tile: int, rng):
    """``CHECK_TILES`` seeded tiles among those where one of the image
    cotangents ``grads`` is not zero (all of them when fewer)."""
    tx, ty = P.ops.projection.num_tiles(w, h, tile)
    mag = grads[0].abs().sum(-1) + grads[1].abs() + grads[2].abs()
    live = np.flatnonzero((P.ops.blend_ref.split_tiles(mag, tx, ty, tile)
                           .amax(1) > 0).cpu().numpy())
    pick = rng.choice(live, min(CHECK_TILES, len(live)), replace=False)
    return torch.from_numpy(np.sort(pick)).to(DEVICE)


def check_step_backward(P, calls, rng, what) -> dict:
    """Kernel 4 and the preprocess backward against their plain versions
    on the inputs ``capture_backward`` took from a regularized coarse
    step: two launches of each, one of kernel 4's with the depth and
    alpha cotangents of the SuGaR terms (checked on ``CHECK_TILES``
    tiles where they are not zero), the other with the photometric
    loss's color cotangent."""
    ops = P.ops
    check(len(calls["blend_bwd"]) == 2 and len(calls["preprocess_bwd"]) == 2,
          f"{what}: {len(calls['blend_bwd'])} kernel-4 and "
          f"{len(calls['preprocess_bwd'])} preprocess-backward launches, not 2")
    err = {"blend_bwd": 0.0, "preprocess_bwd": 0.0}
    notes = []
    has_da = []
    for b, s, _, gc, gd, ga, w, h, tile in calls["blend_bwd"]:
        grads = (gc, gd, ga)
        tiles = cotangent_tiles(P, grads, w, h, tile, rng)
        tx, ty = b.num_tiles_x, b.num_tiles_y
        on = lambda x: ops.blend_ref.split_tiles(x, tx, ty, tile)[tiles]
        n_d, n_a = int((on(gd) != 0).sum()), int((on(ga) != 0).sum())
        has_da.append(n_d > 0 and n_a > 0)
        e, r, zeroed, n_px = check_blend_bwd_binned(
            P, b, s, w, h, tile, rng, f"{what} kernel 4", tiles, grads=grads)
        err["blend_bwd"] = max(err["blend_bwd"], e)
        notes.append(f"kernel 4 on {len(tiles)} tiles ({n_d} and {n_a} "
                     f"pixels with depth and alpha cotangents, {zeroed} of "
                     f"{n_px} zeroed) "
                     f"max abs err {e:.3g} ({r:.3g} of the largest)")
    check(sum(has_da) == 1, f"{what}: {sum(has_da)} of kernel 4's launches "
          "take depth and alpha cotangents on the checked tiles, not 1")
    for g, cam, tiles_touched, d, *a in calls["preprocess_bwd"]:
        got = ops.preprocess_cuda.preprocess_bwd_kernel(g, cam, tiles_touched,
                                                        d, *a)
        want = ops.preprocess_cuda.preprocess_bwd_plain(g, cam, tiles_touched,
                                                        d, *a)
        e, r = check_fields(got, want, PRE_BWD_TOL, f"{what} preprocess_bwd")
        err["preprocess_bwd"] = max(err["preprocess_bwd"], e)
        notes.append(f"preprocess_bwd max abs err {e:.3g} ({r:.3g})")
    sync()
    print(f"check {what}, its own inputs: " + "; ".join(notes) + ": ok")
    return err


def sugar_cli(P, card: str, root: str, budget: int) -> dict:
    """``train_gaussians.main`` on the COLMAP scene under ``root``: each
    3DGS and coarse step's launches, loss and (coarse) time, the stages'
    wall times and the forward renders recorded; the files, states,
    losses, launches, the mesh and its level-set RMS checked."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch import train_gaussians as TG
    from autovfx_tpu_torch.core import ply_io
    from autovfx_tpu_torch.sugar import coarse_train as CT
    from autovfx_tpu_torch.sugar import extract_mesh as EM
    from autovfx_tpu_torch.sugar import levelset as LS
    from autovfx_tpu_torch.sugar import poisson as PO
    from autovfx_tpu_torch.sugar import refine as R
    from autovfx_tpu_torch.train import trainer
    from autovfx_tpu_torch.utils import metrics as MET
    from autovfx_tpu_torch.utils import png

    model = os.path.join(root, "model")
    argv = ["--source_path", root, "--model_path", model, *SUGAR_CLI,
            "--dup_budget", str(budget), "--device", DEVICE]
    clock = StageClock()
    seen = {"coarse": [], "train": []}
    wrapped = [(trainer, "train_step"), (CT, "coarse_step")]
    stages = [(TG, "load_scene", "load"), (trainer, "train", "3DGS"),
              (CT, "coarse_train", "coarse (the rest)"),
              (ply_io, "save_ply", lambda i: ("snapshot ply", "coarse ply",
                                              "export")[min(i, 2)]),
              (EM, "extract_mesh_from_gaussians", "extraction (the rest)"),
              (EM, "extract_level_points", "level points"),
              (EM, "remove_outliers", "outliers"),
              (PO, "_solve", "poisson solve"),
              (PO, "marching_tetrahedra", "marching tets"),
              (PO, "poisson_reconstruct", "poisson prune"),
              (EM, "density_grid_mesh", "background grid"),
              (EM, "decimate_quadric", "decimation"),
              (EM, "prune_far_from_gaussians", "prune"),
              (EM, "vertex_colors", "colours"), (R, "bind_to_mesh", "bind"),
              (R, "realize", "realize"), (R, "bake_texture", "bake"),
              (png, "write_png", "export"), (MET, "evaluate", "metrics")]
    saved = [(o, k, getattr(o, k)) for o, k in wrapped]
    saved += [(o, k, getattr(o, k)) for o, k, _ in stages]
    real_train_step, real_coarse_step = (f for _, _, f in saved[:2])

    def train_step(*a, **k):
        before = bench.kernel_launches()
        state, aux = real_train_step(*a, **k)
        seen["train"].append(({n: c - before[n] for n, c in
                               bench.kernel_launches().items()}, aux.loss))
        return state, aux

    def coarse_step(state, cam, image, cfg, regularize, generator,
                    draws=None):
        counted = lambda: {**bench.kernel_launches(), **field_launches()}
        before = counted()
        sync()
        t0 = time.perf_counter()
        out = real_coarse_step(state, cam, image, cfg, regularize, generator,
                               draws)
        sync()
        seen["coarse"].append((regularize, {n: c - before[n] for n, c in
                                            counted().items()},
                               time.perf_counter() - t0, out[1].loss))
        seen["last"] = (cam, image, cfg, generator)
        return out

    trainer.train_step = train_step
    CT.coarse_step = coarse_step
    for owner, attr, stage in stages:
        clock.wrap(owner, attr, stage)
    saved += counted_renders(clock, (LS, MET))
    field_calls = [0]
    saved += counted_fields(field_calls)
    torch.cuda.reset_peak_memory_stats()
    sync()
    P.utils.trace.reset()
    t0 = time.perf_counter()
    try:
        result = TG.main(argv)
        sync()
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    wall = time.perf_counter() - t0
    launches = bench.kernel_launches()
    fields = field_launches()
    peak = torch.cuda.max_memory_allocated()

    # the files, the states, the losses
    for name in (f"chkpnt{SUGAR_ITERATIONS}.npz",
                 f"point_cloud/iteration_{SUGAR_ITERATIONS}/point_cloud.ply",
                 "sugarcoarse.ply", "mesh.obj", "sugarfine.ply", "texture.png",
                 "metrics.json"):
        check(os.path.getsize(os.path.join(model, name)) > 0,
              f"the CLI did not write {name}")
    check_state(result["state"], "after 3DGS")
    check_state(result["coarse_state"], "after coarse SuGaR")
    losses = ([x.item() for _, x in seen["train"]]
              + [x[3].item() for x in seen["coarse"]])
    check(all(np.isfinite(losses)), "a 3DGS or coarse step loss is not finite")
    coarse_g = result["coarse_state"].gaussians
    n_active = int(coarse_g.num_active)
    check(n_active > 0, "the prune at regularize_from left no Gaussian")

    # launches: each 3DGS step and plain coarse step once, a regularized
    # step twice (kernel 4 and the preprocess backward too) and the
    # density field's forward and backward once each, each forward render
    # (the level set's and the metrics') once, and each evaluation of the
    # field outside a step (the level set's) its forward once
    one = {k: 1 for k in TRAIN_LIKE}
    for i, (counts, _) in enumerate(seen["train"]):
        check_launches(counts, one, f"3DGS step {i + 1}")
    n_reg = 0
    for i, (reg, counts, _, _) in enumerate(seen["coarse"]):
        check(reg == (i + 1 >= SUGAR_REGULARIZE_FROM), f"coarse step {i + 1}")
        check_launches(counts, {**{k: 1 + reg for k in TRAIN_LIKE},
                                "density_fwd": int(reg),
                                "density_bwd": int(reg)},
                       f"coarse step {i + 1} (regularized {reg})")
        n_reg += reg
    check(n_reg > 0 and field_calls[0] > n_reg, f"the CLI evaluated the "
          f"density field {field_calls[0]} times in {n_reg} regularized steps")
    check_launches(fields, {"density_fwd": field_calls[0],
                            "density_bwd": n_reg}, "the CLI's density field")
    n_train, n_coarse = len(seen["train"]), len(seen["coarse"])
    steps = n_train + n_coarse + n_reg
    views = clock.renders
    check(views > 0, "the CLI rendered no view outside its training steps")
    check_launches(launches, {**{k: steps for k in TRAIN_LIKE},
                              "preprocess": steps + views,
                              "duplicate_with_keys": steps + views,
                              "blend_fwd": views}, "the CLI")

    # the mesh and its distance to the level set
    mesh = result["mesh"]
    check(0 < len(mesh.vertices) <= SUGAR_TARGET_VERTICES
          and len(mesh.faces) > 0 and np.isfinite(mesh.vertices).all(),
          f"the mesh: {len(mesh.vertices)} vertices, {len(mesh.faces)} faces")
    rms, n_sel = rms_to_levelset(P, coarse_g, mesh.vertices, 0.3)
    centers = result["cams"].center.cpu().numpy()
    c_ext = np.maximum(centers.max(0) - centers.min(0), 0.5)
    mid = (centers.min(0) + centers.max(0)) / 2
    box = np.random.default_rng(7).uniform(mid - 1.05 * c_ext,
                                           mid + 1.05 * c_ext, (n_sel, 3))
    rms_box, _ = rms_to_levelset(P, coarse_g, box, 0.3)
    check(rms < rms_box, f"sugar_rms_to_levelset {rms:.4f} is not below the "
          f"foreground box's uniform points' {rms_box:.4f}")
    st = {k: dict(v) for k, v in clock.stages.items()}
    coarse_t = {True: [], False: []}
    for reg, _, dt, _ in seen["coarse"]:
        coarse_t[reg].append(dt)
    for name in ("poisson solve", "marching tets"):
        st["poisson prune"]["s"] -= st[name]["s"]
    for name in ("level points", "outliers", "poisson solve",
                 "marching tets", "poisson prune", "background grid",
                 "decimation", "prune", "colours"):
        st["extraction (the rest)"]["s"] -= st[name]["s"]
    st["coarse (the rest)"]["s"] -= sum(coarse_t[True]) + sum(coarse_t[False])
    kept = f"{n_active} of {N_SPLATS} Gaussians past the prune"
    print(f"SuGaR pipeline: the CLI's files written; 3DGS {n_train} steps, "
          f"coarse {n_coarse} ({n_reg} regularized, {kept}); losses "
          f"{losses[0]:.5f} .. {losses[-1]:.5f}; mesh {len(mesh.vertices)} "
          f"vertices, {len(mesh.faces)} faces; sugar_rms_to_levelset "
          f"{rms:.4f} over {n_sel} vertices (uniform points in the "
          f"foreground box: {rms_box:.4f}); metrics PSNR "
          f"{result['metrics']['psnr']:.3f} dB, SSIM "
          f"{result['metrics']['ssim']:.4f}; launches {launches} for {steps} "
          f"training passes and {views} forward renders, the density field "
          f"{fields} for {n_reg} regularized steps and {field_calls[0]} "
          "evaluations")
    print(f"[{card}] SuGaR CLI at {WIDTH}x{HEIGHT} ({kept}): {wall:.1f} s "
          f"wall, peak device memory {peak / 2**30:.2f} GiB; stages (wall s, "
          "each without the stages inside it): " + ", ".join(
              f"{k} {v['s']:.3f}" for k, v in st.items())
          + f"; coarse plain step median "
          f"{statistics.median(coarse_t[False]) * 1000.0:.1f} ms, regularized "
          f"{statistics.median(coarse_t[True]) * 1000.0:.1f} ms")
    return dict(result=result, launches=launches, field_launches=fields,
                last=seen["last"], kept=kept)


def sugar_refine(P, card: str, run: dict, rng) -> tuple[dict, dict]:
    """``refine_train`` on the CLI's bound Gaussians against the 8 views
    (its launches checked), then kernels 1-3, the preprocess backward and
    kernel 4 on the refined Gaussians against their plain versions at the
    refinement's budget."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.core.cameras import index_camera, num_cameras
    from autovfx_tpu_torch.sugar import refine as R
    from autovfx_tpu_torch.sugar import refine_train as RT

    ops = P.ops
    result = run["result"]
    bound, images, cams = result["bound"], result["images"], result["cams"]
    need = lambda x, c: int(ops.binning.required_budget(
        ops.preprocess_cuda.preprocess(x, c, tile=SUGAR_TILE)))
    with torch.no_grad():
        fine = R.realize(bound)
    worst = max(need(fine, index_camera(cams, i))
                for i in range(num_cameras(cams)))
    del fine
    budget = ops.binning.round_budget(worst, slack=BUDGET_SLACK * 1.25)
    rcfg = RT.RefineConfig(iterations=REFINE_STEPS, raster=P.RasterConfig(
        dup_budget=budget, tile=SUGAR_TILE))
    sync()
    P.utils.trace.reset()
    t0 = time.perf_counter()
    refined, hist = RT.refine_train(bound, cams, images, rcfg, log_every=1)
    sync()
    refine_s = time.perf_counter() - t0
    launches = bench.kernel_launches()
    check_launches(launches, {k: REFINE_STEPS for k in TRAIN_LIKE},
                   f"{REFINE_STEPS} refine steps")
    for f in R.PARAM_KEYS:
        check(bool(torch.isfinite(getattr(refined, f)).all()),
              f"refined {f} not finite")
    check(all(np.isfinite(h["loss"]) for h in hist), "a refine loss")
    print(f"[{card}] refine_train: {REFINE_STEPS} steps on "
          f"{bound.num_gaussians} bound Gaussians ({run['kept']}) in "
          f"{refine_s:.2f} s ({refine_s * 1000.0 / REFINE_STEPS:.1f} ms a "
          f"step, budget {budget}), PSNR {hist[0]['psnr']:.3f} -> "
          f"{hist[-1]['psnr']:.3f} dB; launches {launches}")

    with torch.no_grad():
        fine = R.realize(refined)
    cam = index_camera(cams, 0)
    what = f"refined Gaussians ({fine.capacity}) on ring view 0"
    err = check_view_kernels(P, fine, cam, budget, SUGAR_TILE, rng, what)
    e1, r1 = check_preprocess_bwd(P, fine, cam, SUGAR_TILE, rng, what)
    tx, ty = ops.projection.num_tiles(cam.width, cam.height, SUGAR_TILE)
    tiles = torch.from_numpy(rng.choice(tx * ty, CHECK_TILES,
                                        replace=False)).to(DEVICE)
    e2, r2, zeroed, n_px = check_blend_bwd(P, fine, cam, SUGAR_TILE, rng,
                                           what, tiles=tiles)
    sync()
    err.update(preprocess_bwd=e1, blend_bwd=e2)
    print(f"check {what}: preprocess max err {err['preprocess']:.3g}, "
          f"duplicates bit-equal, blend max color err {err['blend_fwd']:.3g}"
          f"; preprocess_bwd {e1:.3g} ({r1:.3g} of the largest), blend_bwd "
          f"{e2:.3g} ({r2:.3g}; {CHECK_TILES} tiles, {zeroed} of {n_px} "
          "pixels zeroed): ok")
    return launches, err


def sugar_pipeline_point(P, card: str) -> tuple[dict, dict]:
    """The port's reconstruction CLI, ``train_gaussians.main``, on a
    COLMAP scene of the bench's garden-like scene at the reference's
    widths (``SUGAR_CLI``; ``sugar_cli``); then ``refine_train`` on the
    bound Gaussians (``sugar_refine``) and the TSDF and density-grid
    extractions, which the CLI does not run, with no render of any of
    them overflowing; then a regularized step's device time by
    operation, and the kernels against their plain versions on that
    step's own inputs and on a ring view of the coarse Gaussians."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.sugar import coarse_train as CT
    from autovfx_tpu_torch.sugar import extract_mesh as EM
    from autovfx_tpu_torch.sugar import levelset as LS
    from autovfx_tpu_torch.sugar import sdf_fusion as SF

    rng = np.random.default_rng(16)
    tmp = tempfile.TemporaryDirectory()
    budget = sugar_scene_files(P, tmp.name)
    with bench.overflow_watch(DEVICE) as overflow:
        run = sugar_cli(P, card, tmp.name, budget)
        refine_launches, err = sugar_refine(P, card, run, rng)
        # the extractions the CLI does not run, on the coarse Gaussians
        coarse_g = run["result"]["coarse_state"].gaussians
        cams = run["result"]["cams"]
        config = P.RasterConfig(dup_budget=budget, tile=SUGAR_TILE)
        side = {}
        for method in ("tsdf", "density_grid"):
            clock = StageClock()
            calls = [0]
            saved = counted_renders(clock, (LS, SF)) + counted_fields(calls)
            sync()
            P.utils.trace.reset()
            t0 = time.perf_counter()
            try:
                m = EM.extract_mesh_from_gaussians(
                    coarse_g, cams, config=config, method=method,
                    fg_resolution=SUGAR_SIDE_RES,
                    target_vertices=SUGAR_TARGET_VERTICES)
                sync()
            finally:
                for owner, attr, fn in saved:
                    setattr(owner, attr, fn)
            side[method] = {**bench.kernel_launches(), **field_launches()}
            n = clock.renders
            check_launches(side[method], {"preprocess": n,
                                          "duplicate_with_keys": n,
                                          "blend_fwd": n,
                                          "density_fwd": calls[0]},
                           f"{method} mesh")
            check(len(m.vertices) > 0 and len(m.faces) > 0
                  and np.isfinite(m.vertices).all(),
                  f"{method} mesh: {len(m.vertices)} vertices")
            print(f"[{card}] extract_mesh_from_gaussians(method={method!r}) "
                  f"at {SUGAR_SIDE_RES} ({run['kept']}): {len(m.vertices)} "
                  f"vertices, {len(m.faces)} faces in "
                  f"{time.perf_counter() - t0:.2f} s; launches {side[method]} "
                  f"for {n} renders and {calls[0]} evaluations of the field")
        check(not bool(overflow["any"]), "SuGaR pipeline: a render of the "
              "CLI, the refinement or the side extractions overflowed")

    # a regularized step: kernel 4 and the preprocess backward on the
    # inputs it gives them (the first launch of the run), then its device
    # time, busy, idle and operations
    cam, image, cfg, gen = run["last"]
    state = run["result"]["coarse_state"]
    step = lambda: CT.coarse_step(state, cam, image, cfg, True, gen)
    what = (f"a regularized coarse step ({state.gaussians.capacity} slots, "
            f"{run['kept']})")
    for k, e in check_step_backward(P, capture_backward(P, step), rng,
                                    what).items():
        err[k] = max(err[k], e)
    step_ms = cuda_ms(step, 5)
    records = profiled(step, 3)
    busy = sum(e.duration_ns() for e in records) / 1e6 / 3
    ops_ms = {}
    for e in records:
        ops_ms[e.name()] = (ops_ms.get(e.name(), 0.0)
                            + e.duration_ns() / 1e6 / 3)
    top = sorted(ops_ms.items(), key=lambda kv: -kv[1])[:12]
    print(f"[{card}] a regularized coarse step ({run['kept']}): {step_ms:.1f} "
          f"ms (CUDA events, median of 5), device busy {busy:.1f} ms "
          f"(profiler, mean of 3), idle share {1.0 - busy / step_ms:.3f}, "
          f"{len(records) // 3} device records; top device operations (ms "
          "a step): " + "; ".join(f"{name[:90]} {ms:.2f}" for name, ms in top))

    # kernels 1-3 on a ring view of the coarse Gaussians at the CLI's
    # budget
    what = f"coarse Gaussians ({run['kept']}) on ring view {cam.width}x" \
           f"{cam.height}"
    view_err = check_view_kernels(P, state.gaussians, cam, budget, SUGAR_TILE,
                                  rng, what)
    print(f"check {what}: preprocess max err {view_err['preprocess']:.3g}, "
          f"duplicates bit-equal, blend max color err "
          f"{view_err['blend_fwd']:.3g} on {CHECK_TILES} tiles: ok")
    for k, e in view_err.items():
        err[k] = max(err[k], e)
    total = {k: run["launches"][k] + refine_launches[k]
             + sum(side[m][k] for m in side) for k in run["launches"]}
    total["blend_fwd"] += total.pop("blend_fwd_train")
    for k, n in run["field_launches"].items():
        total[k] = n + sum(side[m][k] for m in side)
    del state, run
    tmp.cleanup()
    return total, err


def shell_gaussians(device):
    """``tests/test_sugar.py``'s 600-splat sphere shell (numpy, seed 0),
    with uneven scales and rotations (at isotropic scales a rotation's
    gradient is rounding noise, which Adam's first normalized step turns
    into a full step of either sign) and opacities below the 0.99 clamp."""
    from autovfx_tpu_torch.core.gaussians import Gaussians

    rng = np.random.default_rng(0)
    n = SHELL_SPLATS
    d = rng.standard_normal((n, 3))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Gaussians(
        xyz=t(d / np.linalg.norm(d, axis=1, keepdims=True)),
        sh_dc=t(rng.standard_normal((n, 3))),
        sh_rest=t(0.05 * rng.standard_normal((n, 15, 3))),
        log_scales=t(np.log(0.06) + 0.3 * rng.standard_normal((n, 3))),
        quats=t(rng.standard_normal((n, 4))),
        opacity_logit=t(np.clip(rng.normal(0.5, 1.5, n), -4.0, 4.0)),
        active=torch.ones(n, dtype=torch.bool, device=device))


def shell_camera(device, angle: float = 0.0):
    """A 64×48 camera 3 m from the shell's centre, at ``angle`` about z."""
    from autovfx_tpu_torch.core.cameras import look_at_camera

    return look_at_camera(
        [3.0 * np.cos(angle), 3.0 * np.sin(angle), 0.5], [0, 0, 0], [0, 0, 1],
        fx=60.0, fy=60.0, width=SHELL_W, height=SHELL_H, device=device)


def sugar_shell_case(P, device):
    """One plain and one regularized coarse step on the 600-splat shell
    toward a render of its colours reversed (the sample draws made on the
    CPU, so every device takes the same), and the level set of the
    camera after them: (state, (plain loss, regularized loss), level
    set)."""
    import dataclasses as dc

    from autovfx_tpu_torch.sugar import coarse_train as CT
    from autovfx_tpu_torch.sugar import density as D
    from autovfx_tpu_torch.sugar import levelset as LS
    from autovfx_tpu_torch.train import trainer

    config = P.RasterConfig(dup_budget=1 << 14)
    g_cpu = shell_gaussians("cpu")
    with torch.no_grad():
        target = P.rasterize(dc.replace(g_cpu, sh_dc=g_cpu.sh_dc.flip(0)),
                             shell_camera("cpu"), config=config).color
    cfg = CT.SugarConfig(
        base=trainer.TrainConfig(raster=config, spatial_lr_scale=2.0,
                                 densify_from_iter=10**9),
        regularize_from=2, n_sdf_samples=SHELL_SAMPLES)
    draws = D.draw_samples(g_cpu, torch.Generator().manual_seed(0),
                           SHELL_SAMPLES)
    state = trainer.init_state(shell_gaussians(device))
    c, img = shell_camera(device), target.to(device)
    state, a1 = CT.coarse_step(state, c, img, cfg, False, None)
    state, a2 = CT.coarse_step(state, c, img, cfg, True, None,
                               draws=tuple(x.to(device) for x in draws))
    ls = LS.level_surface_from_camera(state.gaussians, c, config=config)
    return state, (a1.loss.item(), a2.loss.item()), ls


def sugar_card_against_cpu(P) -> None:
    """SuGaR's small cases on the card and on the CPU: one plain and one
    regularized coarse step (the same draws), the level set of a camera
    and the Poisson mesh of its cloud."""
    from scipy.spatial import cKDTree

    from autovfx_tpu_torch.core.cameras import stack_cameras
    from autovfx_tpu_torch.core.gaussians import PARAM_FIELDS
    from autovfx_tpu_torch.sugar import extract_mesh as EM
    from autovfx_tpu_torch.sugar import poisson as PO

    (s_c, (l1_c, l2_c), ls_c), (s_g, (l1_g, l2_g), ls_g) = (
        sugar_shell_case(P, dev) for dev in ("cpu", DEVICE))
    for what, got, want in (("plain", l1_g, l1_c), ("regularized", l2_g, l2_c)):
        check(abs(got - want) <= LOSS_RTOL * abs(want),
              f"card vs CPU: the {what} coarse step's loss {got} vs {want}")
    worst = {}
    for f in PARAM_FIELDS:
        want = getattr(s_c.gaussians, f)
        err = (getattr(s_g.gaussians, f).cpu() - want).abs().max().item()
        worst[f] = err / max(want.abs().max().item(), 1e-12)
        check(worst[f] <= STATE_TOL, f"card vs CPU: {f} after two coarse "
              f"steps off by {worst[f]:.3g} of its largest")
    v_c, v_g = ls_c.valid.numpy(), ls_g.valid.cpu().numpy()
    agree = float((v_c == v_g).mean())
    both = v_c & v_g
    p_err = float(np.abs(ls_g.points.cpu().numpy()[both]
                         - ls_c.points.numpy()[both]).max())
    check(agree >= LEVEL_AGREE and both.sum() > 100
          and p_err <= LEVEL_POINT_TOL,
          f"card vs CPU level set: masks agree on {agree:.4f}, points "
          f"{p_err:.3g} apart on {both.sum()} rays")
    # the Poisson mesh of the CPU's cloud of two views, solved on both
    cams2 = stack_cameras([shell_camera("cpu"), shell_camera("cpu", np.pi)])
    pts, nrm = EM.extract_level_points(
        s_c.gaussians, cams2, config=P.RasterConfig(dup_budget=1 << 14),
        every_nth=1)
    lo, hi = np.percentile(pts, 1, axis=0), np.percentile(pts, 99, axis=0)
    meshes = {dev: PO.poisson_reconstruct(pts, -nrm, lo, hi,
                                          resolution=SHELL_POISSON_RES,
                                          device=dev)
              for dev in ("cpu", DEVICE)}
    (vc, fc), (vg, fg) = meshes["cpu"], meshes[DEVICE]
    voxel = float(np.linalg.norm((hi - lo) * 1.3 / (SHELL_POISSON_RES - 1)))
    far = float(cKDTree(vc).query(vg)[0].max()) if len(vg) else np.inf
    check(len(vc) > 100 and abs(len(vg) - len(vc)) <= 0.01 * len(vc)
          and far <= voxel,
          f"card vs CPU Poisson: {len(vg)} vs {len(vc)} vertices, the "
          f"farthest card vertex {far:.3g} from the CPU mesh (voxel diagonal "
          f"{voxel:.3g})")
    print(f"SuGaR card vs CPU (the {SHELL_SPLATS}-splat shell at "
          f"{SHELL_W}x{SHELL_H}): coarse losses {l1_g:.7f}/{l2_g:.7f} vs "
          f"{l1_c:.7f}/{l2_c:.7f}; fields after Adam off by at most "
          + ", ".join(f"{k} {v:.2g}" for k, v in worst.items())
          + f" of their largest; level set masks agree on {agree:.4f}, points"
          f" within {p_err:.2g}; Poisson {len(vg)} vs {len(vc)} vertices, the"
          f" farthest {far:.3g} (voxel diagonal {voxel:.3g}): ok")


# ---- SuGaR's density field --------------------------------------------------
#
# The two kernels of csrc/density_field.cu (ops/density_cuda) against the
# elementwise twin (sugar/density.field_twin) on the card, and timed at
# the sugar-coarse-1m cell's shapes: 1M splats of the garden-like scene,
# 1M samples drawn in them, each with its source splat's 16 neighbours.
FIELD_SPLATS, FIELD_SAMPLES, FIELD_K = 1_000_000, 1_000_000, 16
# each density and gradient is a sum of 16 float32 terms, in another
# order than the twin's
FIELD_FWD_RTOL = 1e-5  # of the largest value
# a splat's gradient sums the pairs of tens of samples by atomics in no
# fixed order (the twin's index_add_ too), and its terms cancel
FIELD_BWD_RTOL = 1e-4  # of each field's largest
# and each element against itself: |got - twin| <= FIELD_ELEM_RTOL *
# (|twin| + FIELD_FLOOR * the largest |twin|).  The outputs are heavy-
# tailed (at the cell's shapes a splat gradient's median is 2e-3 to 2e-2
# of its largest), so the limits of the largest alone would pass a kernel
# wrong on the typical element; an element that cancels near the floor
# keeps a few float32 ulps of its terms, which the floor absorbs
FIELD_ELEM_RTOL, FIELD_FLOOR = 5e-3, 1e-4
# float32 operations a (sample, neighbour) pair, an FMA 2, counted from
# the kernels' expressions: the forward's d, A d, q, the weight and the
# four sums; the backward's recomputation, c, A g, dL/dx and its sum,
# and the ten splat gradients; each pass takes one exp a pair
FIELD_FWD_FLOPS, FIELD_BWD_FLOPS = 36, 110
FIELD_RECORD_BYTES = 40  # centre, opacity, six entries: what a splat holds


def field_work(n: int, samples: int, k: int, backward: bool
               ) -> tuple[float, float, float]:
    """(bytes, flops, exps) of one pass of the field: each sample's point
    and int32 neighbour row read, its density and gradient (forward) or
    their cotangents and dL/dpoint (backward), and each splat's record
    read once (and its gradient written once, backward)."""
    pairs = samples * k
    per_sample = 12 + 4 * k + 16 + (12 if backward else 0)
    per_splat = FIELD_RECORD_BYTES * (2 if backward else 1)
    flops = FIELD_BWD_FLOPS if backward else FIELD_FWD_FLOPS
    return samples * per_sample + n * per_splat, flops * pairs, pairs


def field_inputs(n_splats: int, n_samples: int, k: int, seed: int, device,
                 edge_cases: bool = False) -> tuple:
    """(points, int64 neighbour rows, centres, opacities, inverse-covariance
    entries): samples drawn in garden-like splats, each with its source
    splat's k nearest neighbours.  ``edge_cases`` adds rows of one repeated
    neighbour, runs of 64 samples that share one row (atomic collisions
    within and across rows), every 7th splat at opacity 0 and every 11th
    sample 20 m off, where each pair's exp underflows."""
    from autovfx_tpu_torch.sugar import density as D
    from autovfx_tpu_torch.utils.gather import take
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    g = make_garden_like(n_splats, seed=seed, extent=EXTENT, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pts, src = D.sample_points_in_gaussians(g, gen, n_samples)
    nbrs = take(D.reset_neighbors(g, k=k), src)
    centers, opacity, entries = D._splats(g)
    if edge_cases:
        nbrs[::5] = nbrs[::5, :1].clone()
        m = n_samples // 2 // 64 * 64
        runs = nbrs[:m].view(m // 64, 64, k)
        runs[:] = runs[:, :1].clone()
        opacity = opacity.clone()
        opacity[::7] = 0.0
        pts = pts.clone()
        pts[::11] += 20.0
    return pts, nbrs, centers, opacity, entries


def field_grads(fn, inputs: tuple, cot_dens, cot_grad) -> list:
    """``fn(points, neighbors, centers, opacity, entries)``'s density and
    gradient and, from the cotangents (either None), the gradients in the
    points, centres, opacities and entries."""
    pts, nbrs, *splats = inputs
    leaves = [x.detach().clone().requires_grad_(True) for x in (pts, *splats)]
    dens, grad = fn(leaves[0], nbrs, *leaves[1:])
    loss = sum(torch.sum(out * c) for out, c in ((dens, cot_dens),
                                                 (grad, cot_grad))
               if c is not None)
    grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
             if loss.requires_grad else [None] * len(leaves))
    return [dens.detach(), grad.detach()] + [
        torch.zeros_like(x) if gr is None else gr
        for x, gr in zip(leaves, grads)]


FIELD_OUTPUTS = ("density", "gradient", "d/dpoints", "d/dcenters",
                 "d/dopacity", "d/dentries")


def field_errors(got: list, want: list) -> dict:
    """Each output's largest gap over the twin's largest magnitude (the gap
    itself where that is 0), and its largest gap element by element over
    ``|twin| + FIELD_FLOOR * largest``: ``{name: (largest, each)}``."""
    out = {}
    for name, a, b in zip(FIELD_OUTPUTS, got, want):
        if not b.numel():
            out[name] = (0.0, 0.0)
            continue
        gap, mag = (a - b).abs(), b.abs()
        scale = float(mag.max())
        each = float((gap / (mag + FIELD_FLOOR * scale)).max()) \
            if scale > 0 else float(gap.max())
        out[name] = (float(gap.max()) / scale if scale > 0
                     else float(gap.max()), each)
    return out


def check_field(errs: dict, what: str) -> None:
    for name, (largest, each) in errs.items():
        tol = FIELD_FWD_RTOL if name in ("density", "gradient") \
            else FIELD_BWD_RTOL
        check(largest <= tol, f"{what}: the density field's {name} off by "
              f"{largest:.3g} of the twin's largest (limit {tol:g})")
        check(each <= FIELD_ELEM_RTOL, f"{what}: the density field's {name} "
              f"off by {each:.3g} of an element (limit {FIELD_ELEM_RTOL:g} "
              f"over a floor of {FIELD_FLOOR:g} of the largest)")


def field_launches() -> dict:
    """The density field's kernels' launch counts (``trace``'s
    ``launch.density_fwd`` and ``launch.density_bwd``; the card only)."""
    from autovfx_tpu_torch.utils import trace

    counts = trace.counters()
    return {k: counts.get(f"launch.{k}", 0) for k in FIELD_KERNELS}


def counted_fields(calls: list) -> list:
    """Count each call of ``ops/density_cuda.density_field``, which
    launches the forward once, in ``calls[0]``; returns the ``(owner,
    attr, fn)`` to restore."""
    from autovfx_tpu_torch.ops import density_cuda as DC

    fn = DC.density_field

    def field(*a, **k):
        calls[0] += 1
        return fn(*a, **k)

    DC.density_field = field
    return [(DC, "density_field", fn)]


def density_field_point(P, card: str, path_launches: dict | None = None
                        ) -> list[dict]:
    """The field's kernels at the cell's shapes: held to the twin on the
    card, both cotangents; each kernel's device time beside its bound and
    the twin's (forward alone; forward and backward less forward).  The
    rows' launches are ``path_launches``' (the SuGaR pipeline point's,
    whose regularized coarse steps each launch both once), where given."""
    from autovfx_tpu_torch.ops import density_cuda as DC
    from autovfx_tpu_torch.sugar import density as D

    inputs = field_inputs(FIELD_SPLATS, FIELD_SAMPLES, FIELD_K, 21, DEVICE)
    pts, nbrs, centers, opacity, entries = inputs
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    cot = (torch.randn(pts.shape[:1], generator=gen, device=DEVICE),
           torch.randn(pts.shape, generator=gen, device=DEVICE))
    P.utils.trace.reset()
    got = field_grads(DC.density_field, inputs, *cot)
    counts = P.utils.trace.counters()
    want = field_grads(D.field_twin, inputs, *cot)
    errs = field_errors(got, want)
    check_field(errs, f"{FIELD_SAMPLES} samples x {FIELD_K}")
    check_launches({k: counts.get(f"launch.{k}", 0) for k in FIELD_KERNELS},
                   {"density_fwd": 1, "density_bwd": 1},
                   "the density field's forward and backward")
    print(f"check the density field ({FIELD_SAMPLES} samples x {FIELD_K} "
          f"neighbours, {FIELD_SPLATS} splats) against the twin, of the "
          "largest / of each element: " + ", ".join(
              f"{k} {a:.3g} / {b:.3g}" for k, (a, b) in errs.items())
          + ": ok")
    del got, want

    nb32 = nbrs.to(torch.int32)
    table = DC.pack_table(centers, opacity, entries)
    fwd = lambda: DC.field_fwd_kernel(pts, nb32, table)
    bwd = lambda: DC.field_bwd_kernel(pts, nb32, table, *cot)
    with torch.no_grad():
        twin_fwd = lambda: D.field_twin(pts, nbrs, centers, opacity, entries)
        ms_fwd, plain_fwd = in_turns(twin_fwd, fwd, 3, "density_fwd_kernel")
    twin_both = lambda: field_grads(D.field_twin, inputs, *cot)
    ms_bwd = (device_ms(bwd, KERNEL_REPS, "density_bwd_kernel")
              + device_ms(bwd, KERNEL_REPS, "density_bwd_kernel")) / 2
    plain_bwd = device_ms(twin_both, 3) - plain_fwd
    clock = sm_clock_mhz()
    rows = []
    for name, ms, plain, backward in (("density_fwd", ms_fwd, plain_fwd, False),
                                      ("density_bwd", ms_bwd, plain_bwd, True)):
        work = field_work(FIELD_SPLATS, FIELD_SAMPLES, FIELD_K, backward)
        tb = timed_bound(ms, work, clock)
        print(f"[{card}] {name}: {ms:.4f} ms (device, the profiler), bound "
              f"{tb['bound_ms']:.4f} ms ({tb['bound_by']}), share "
              f"{tb['share']:.3f}; the twin {plain:.3f} ms")
        by_path = ({} if path_launches is None
                   else {"sugar_pipeline": path_launches[name]})
        rows.append(dict(
            name=name, route="cuda", **FIELD_KERNELS[name],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(e for k, (e, _) in errs.items()
                            if k.startswith("d/d") == backward),
            ms=ms, plain_ms=plain, bound_ms=tb["bound_ms"],
            bound_by=tb["bound_by"], bound_rate=tb["bound_rate"],
            share=tb["share"], paths={"sugar_coarse_1m_shapes": tb}))
    return rows


# ---- multi-device point ------------------------------------------------------
#
# The parallel layer (autovfx_tpu_torch/parallel) at the training point's
# state: the Garden-like 1M splats in 1.25M slots, the ring, tile 32.  One
# NCCL rank on the card (its all-reduce is a copy), then MD_RANKS gloo
# ranks sharing the card (NCCL refuses two ranks on one card; gloo moves
# each message through the host), each path held to the JAX package's
# bounds (tests/test_parallel.py:47-66).  The D > 1 times are four ranks
# on one card, not a scaling figure.
MD_RANKS = 4
MD_ONE_RANK = "nccl"  # the one-rank world's backend
MD_DP_CAMERAS = (0, 2, 4, 6)  # one ring camera a rank
MD_TIMED = 5
SLAB_COLOR_ATOL, SLAB_DEPTH_ATOL = 2e-3, 5e-3
DP_LOSS_RTOL = 1e-4
ALPHA_ROUNDING = 1.2e-7  # a slab's alpha is 1 - (1 - alpha) at D = 1
GRAD_STATS_TOL = 1e-4  # the summed NDC norms: atomics in no fixed order
# Adam's first step moves a parameter by lr · sign(mean gradient), so where
# the DP step's and the reference's mean gradients differ in sign (both
# rounding noise about zero: the backward sums with atomics) the two
# parameters differ by 2 lr; such elements, at most this share, are left
# out of the parameters' comparison and counted
MAX_SIGN_FLIPS = 1e-5
# the trajectory's reshard rule (sharding.sharded_render_trajectory)
RESHARD_TRANSLATION, RESHARD_COS = 0.25, 0.97


def expected_reshards(cams, radius: float) -> int:
    """The slab builds of a trajectory by the reshard rule, recomputed:
    a new anchor where the camera moved more than 0.25 × the scene radius
    or turned past cos 0.97 (a build that overflows is retried, not
    counted again)."""
    anchor, n = None, 0
    for cam in cams:
        if anchor is None or (
                float(torch.linalg.norm(cam.center - anchor.center))
                > RESHARD_TRANSLATION * radius
                or float(torch.dot(cam.R[2], anchor.R[2])) < RESHARD_COS):
            anchor, n = cam, n + 1
    return n


def slab_errors(out, color, depth, alpha) -> tuple[float, float, float]:
    """Max |composite - reference| of color, depth and alpha (host)."""
    return tuple(float((a.cpu() - b.cpu()).abs().max())
                 for a, b in zip(out, (color, depth, alpha)))


def check_slab(errs, what: str) -> None:
    check(errs[0] <= SLAB_COLOR_ATOL and errs[2] <= SLAB_COLOR_ATOL
          and errs[1] <= SLAB_DEPTH_ATOL,
          f"{what}: color, depth, alpha max err {errs} (bounds "
          f"{SLAB_COLOR_ATOL}, {SLAB_DEPTH_ATOL})")


def path_counts(c: dict) -> dict:
    """A path's launches by kernel: kernel 3's two entries together."""
    c = dict(c)
    c["blend_fwd"] += c.pop("blend_fwd_train")
    return c


def slab_paths_launches(frames: int) -> dict:
    """One DP step, three slab renders and ``frames`` trajectory frames."""
    renders = 3 + frames
    return {"preprocess": 1 + renders, "duplicate_with_keys": 1 + renders,
            "blend_fwd": renders, "blend_fwd_train": 1, "blend_bwd": 1,
            "preprocess_bwd": 1}


def check_dp_state(state, ref, what: str) -> tuple[float, int, int]:
    """A DP step's state against a reference state after one step: the
    densify counts equal, the summed NDC norms within GRAD_STATS_TOL and
    the Adam moments within STATE_TOL of each field's largest, and the
    parameters too but where the two mean gradients differ in sign (at
    most MAX_SIGN_FLIPS of them).  Returns (the largest error, the
    elements of another sign, the elements)."""
    from autovfx_tpu_torch.core.gaussians import PARAM_FIELDS

    check(torch.equal(state.stats.denom, ref.stats.denom)
          and torch.equal(state.stats.max_radii, ref.stats.max_radii),
          f"{what}: the densify counts differ")
    rel = lambda a, b, keep=1: float(((a - b).abs() * keep).max()
                                     / b.abs().max())
    errs = {"grad_accum": rel(state.stats.grad_accum, ref.stats.grad_accum)}
    check(errs["grad_accum"] <= GRAD_STATS_TOL,
          f"{what}: grad_accum off by {errs['grad_accum']}")
    flips = n = 0
    for f in PARAM_FIELDS:
        for name in ("m", "v"):
            errs[f"{name}.{f}"] = rel(getattr(getattr(state.adam, name), f),
                                      getattr(getattr(ref.adam, name), f))
        same = (torch.sign(getattr(state.adam.m, f))
                == torch.sign(getattr(ref.adam.m, f)))
        flips += int((~same).sum())
        n += same.numel()
        errs[f] = rel(getattr(state.gaussians, f), getattr(ref.gaussians, f),
                      same)
    bad = {k: e for k, e in errs.items() if k != "grad_accum" and e > STATE_TOL}
    check(not bad and flips <= MAX_SIGN_FLIPS * n,
          f"{what}: {bad}; {flips} of {n} mean gradients of another sign")
    return max(errs.values()), flips, n


def one_nccl_rank(P, card, cams, target, cfg, images, start) -> tuple:
    """The paths over one NCCL rank against the single-device ones."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.core.cameras import stack_cameras
    from autovfx_tpu_torch.parallel import make_mesh
    from autovfx_tpu_torch.parallel import mesh as M
    from autovfx_tpu_torch.parallel import sharding as S
    from autovfx_tpu_torch.train import trainer

    mesh = make_mesh((1, 1), backend=MD_ONE_RANK, device=DEVICE)
    x = torch.randn(1 << 20, device=DEVICE)
    check(torch.equal(M.all_reduce(x.clone(), mesh, "data"), x),
          "an all-reduce over one NCCL rank is not a copy")
    cam, img, cfg_r = cams[0], images[0], cfg.raster
    bg = torch.tensor([0.3, 0.2, 0.1], device=DEVICE)
    ring = stack_cameras(cams)

    def paths():
        s_dp, a_dp = S.dp_train_step(trainer.init_state(start), cam, img, cfg,
                                     mesh)
        full = S.sharded_render(S.shard_gaussians(target, cam, 1, 0), cam,
                                mesh, cfg_r, bg)
        compact, c_ovf = S.shard_gaussians_compact(target, cam, 1, 0)
        comp = S.sharded_render_compact(compact, cam, mesh, cfg_r, bg)
        store = S.round_robin_store(target, 1, 0)
        built, d_ovf = S.distributed_shard_compact(store, cam, mesh)
        dist_out = S.sharded_render_compact(built, cam, mesh, cfg_r, bg)
        frames, reshards = S.sharded_render_trajectory(store, ring, N_CAMS,
                                                       mesh, cfg_r, bg)
        return (s_dp, a_dp, full, comp, dist_out, frames, reshards,
                bool(c_ovf), bool(d_ovf))

    sync()
    P.utils.trace.reset()
    (s_dp, a_dp, full, comp, dist_out, frames, reshards, c_ovf,
     d_ovf) = paths()
    sync()
    launches = bench.kernel_launches()
    check_launches(launches, slab_paths_launches(N_CAMS),
                   "multi-device, one NCCL rank")

    s_seq, a_seq = trainer.train_step(trainer.init_state(start), cam, img,
                                      cfg)
    for name, a, b in (("loss", a_dp.loss, a_seq.loss),
                       ("psnr", a_dp.psnr, a_seq.psnr),
                       ("densify visibility", s_dp.stats.denom,
                        s_seq.stats.denom),
                       ("densify radii", s_dp.stats.max_radii,
                        s_seq.stats.max_radii)):
        check(torch.equal(a, b), f"one NCCL rank: dp_train_step's {name} is "
              "not train_step's")
    worst, flips, n_params = check_dp_state(s_dp, s_seq, "one NCCL rank")
    with torch.no_grad():
        ref = P.rasterize(target, cam, bg=bg, config=cfg_r)
        check(not bool(ref.overflow), "multi-device reference: overflow")
        errs = {}
        for name, out in (("full", full), ("compact", comp),
                          ("distributed", dist_out)):
            errs[name] = slab_errors(out, ref.color, ref.depth, ref.alpha)
            check(errs[name][0] == 0.0 and errs[name][1] == 0.0
                  and errs[name][2] <= ALPHA_ROUNDING,
                  f"one NCCL rank, {name} slab: {errs[name]}")
        traj_err = max(float((frames[f] - P.rasterize(
            target, cams[f], bg=bg, config=cfg_r).color).abs().max())
            for f in range(N_CAMS))
    check(traj_err == 0.0, f"one NCCL rank, trajectory: {traj_err}")
    radius = float(torch.linalg.norm(target.xyz, dim=-1).max())
    want_reshards = expected_reshards(cams, radius)
    check(reshards == want_reshards and not c_ovf and not d_ovf,
          f"one NCCL rank: {reshards} reshards (the rule: {want_reshards}),"
          f" overflow {c_ovf} {d_ovf}")
    print(f"multi-device, one NCCL rank: dp_train_step's loss, PSNR and "
          f"densify counts equal train_step's, the state within {worst:.2g} "
          f"of each field's largest ({flips} of {n_params} gradients of "
          f"another sign: the backward's atomics); the full, compact and distributed slab renders and "
          f"the {N_CAMS}-frame trajectory ({reshards} builds, the rule's "
          f"count) equal rasterize (alpha within "
          f"{max(e[2] for e in errs.values()):.2g}): ok")

    # the wrappers' overhead at D = 1, in turns
    state_dp, state_seq = trainer.init_state(start), trainer.init_state(start)
    store = S.round_robin_store(target, 1, 0)
    compact, _ = S.shard_gaussians_compact(target, cam, 1, 0)
    times = {
        "train_step": cuda_ms(lambda: trainer.train_step(
            state_seq, cam, img, cfg), MD_TIMED),
        "dp_train_step": cuda_ms(lambda: S.dp_train_step(
            state_dp, cam, img, cfg, mesh), MD_TIMED),
        "rasterize": cuda_ms(lambda: P.rasterize(target, cam, bg=bg,
                                                 config=cfg_r), MD_TIMED),
        "sharded_render": cuda_ms(lambda: S.sharded_render(
            S.shard_gaussians(target, cam, 1, 0), cam, mesh, cfg_r, bg),
            MD_TIMED),
        "sharded_render_compact": cuda_ms(lambda: S.sharded_render_compact(
            compact, cam, mesh, cfg_r, bg), MD_TIMED),
        "distributed build + render": cuda_ms(
            lambda: S.sharded_render_compact(S.distributed_shard_compact(
                store, cam, mesh)[0], cam, mesh, cfg_r, bg), MD_TIMED),
    }
    print(f"[{card}] D = 1 over NCCL (median of {MD_TIMED}, CUDA events): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))
    return launches, times


def multi_device_rank(rank: int, world: int, spec: dict) -> dict:
    """One of the gloo ranks sharing the card: the DP step with ring
    camera ``MD_DP_CAMERAS[rank]``, the full-capacity, compact and
    distributed slab renders of camera 0 and the ring as a trajectory,
    each path counted and its peak memory read with only its own inputs
    held; rank 0 also takes the DP reference.  The rank runs at the
    parent's operating point (``spec["constants"]``)."""
    from autovfx_tpu_torch import bench

    globals().update(spec["constants"])
    P = import_port()
    from autovfx_tpu_torch.core.cameras import stack_cameras
    from autovfx_tpu_torch.core.gaussians import PARAM_FIELDS
    from autovfx_tpu_torch.parallel import make_mesh
    from autovfx_tpu_torch.parallel import sharding as S
    from autovfx_tpu_torch.train import trainer
    from autovfx_tpu_torch.train.densify import DensifyStats
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    dev = torch.device(DEVICE)
    on_card = dev.type == "cuda"
    peak = lambda: torch.cuda.max_memory_allocated() if on_card else 0
    reset_peak = (torch.cuda.reset_peak_memory_stats if on_card
                  else lambda: None)
    cams = bench.ring_cameras(WIDTH, HEIGHT, N_CAMS, DEVICE)
    target = make_garden_like(N_SPLATS, seed=0, extent=EXTENT, device=dev)
    cfg = trainer.TrainConfig(raster=P.RasterConfig(
        dup_budget=spec["budget"], tile=TILE), spatial_lr_scale=EXTENT)
    images, start = train_targets(P, target, cams, cfg)
    mesh_dp = make_mesh((world, 1), backend="gloo", device=dev)
    mesh_g = make_mesh((1, world), backend="gloo", device=dev)
    bg = torch.tensor([0.3, 0.2, 0.1], device=dev)
    c = MD_DP_CAMERAS[rank]
    out = {"peaks": {}, "ms": {}}
    launches = dict.fromkeys(bench.kernel_launches(), 0)

    def counted(fn):
        sync_any()
        P.utils.trace.reset()
        r = fn()
        sync_any()
        for k, n in bench.kernel_launches().items():
            launches[k] += n
        return r

    def sync_any():
        if on_card:
            sync()

    # the DP step, then (rank 0) its reference: the mean of the four
    # single-camera gradients and one apply_adam
    state, aux = counted(lambda: S.dp_train_step(
        trainer.init_state(start), cams[c], images[c], cfg, mesh_dp))
    if on_card:
        timed = trainer.init_state(start)
        out["ms"]["dp_train_step"] = cuda_ms(lambda: S.dp_train_step(
            timed, cams[c], images[c], cfg, mesh_dp), MD_TIMED)
        del timed
    if rank == 0:
        total, losses, stats = None, [], DensifyStats.zero(start.capacity,
                                                           device=dev)
        for ci in MD_DP_CAMERAS:
            loss, (radii, _, _), grads, off = trainer.loss_and_grads(
                start, lambda g, o, ci=ci: trainer.compute_loss(
                    g, o, cams[ci], images[ci], cfg))
            losses.append(float(loss))
            total = grads if total is None else {
                f: total[f] + grads[f] for f in PARAM_FIELDS}
            stats = stats.update(off, radii, WIDTH, HEIGHT)
        ref = trainer.init_state(start)
        g_ref, adam_ref = trainer.apply_adam(
            ref.gaussians, ref.adam, {f: total[f] / world
                                      for f in PARAM_FIELDS}, 0, cfg)
        ref = trainer.TrainState(gaussians=g_ref, adam=adam_ref, stats=stats,
                                 step=1)
        want_loss = float(np.mean(losses))
        check(abs(float(aux.loss) - want_loss) <= DP_LOSS_RTOL * want_loss,
              f"DP loss {float(aux.loss)} vs the mean {want_loss}")
        worst, flips, n_params = check_dp_state(
            state, ref, f"the DP step over cameras {MD_DP_CAMERAS}")
        out["dp"] = {"loss": float(aux.loss), "want_loss": want_loss,
                     "worst": worst, "flips": flips, "n_params": n_params}
        del total, ref, g_ref, adam_ref, grads, off, radii, stats
    del state, start, images

    # the references, on the host; then each slab path holding only its
    # own inputs
    with torch.no_grad():
        ref = P.rasterize(target, cams[0], bg=bg, config=cfg.raster)
        check(not bool(ref.overflow), "D = 4 reference: overflow")
        ref = tuple(x.cpu() for x in (ref.color, ref.depth, ref.alpha))
        frames_ref = [P.rasterize(target, cam, bg=bg, config=cfg.raster)
                      .color.cpu() for cam in cams]
        radius = float(torch.linalg.norm(target.xyz, dim=-1).max())
        errs = {}
        full = S.shard_gaussians(target, cams[0], world, rank)
        reset_peak()
        got = counted(lambda: S.sharded_render(full, cams[0], mesh_g,
                                               cfg.raster, bg))
        out["peaks"]["full"] = peak()
        errs["full"] = slab_errors(got, *ref)
        if on_card:
            out["ms"]["sharded_render"] = cuda_ms(lambda: S.sharded_render(
                full, cams[0], mesh_g, cfg.raster, bg), MD_TIMED)
        compact, c_ovf = S.shard_gaussians_compact(target, cams[0], world,
                                                   rank)
        # the store in a seeded arbitrary order, as a loader leaves it
        # (make_garden_like's rows run ground, clutter, shell: striped as
        # they are, each stripe's splats crowd a few slabs, and the pairs
        # overflow their blocks)
        order = torch.randperm(N_SPLATS, generator=torch.Generator()
                               .manual_seed(0)).to(dev)
        store = S.round_robin_store(dataclasses.replace(target, **{
            f.name: getattr(target, f.name)[order]
            for f in dataclasses.fields(target)}), world, rank)
        store = dataclasses.replace(store, **{
            f.name: getattr(store, f.name).clone()
            for f in dataclasses.fields(store)})
        del full, target, order
        reset_peak()
        got = counted(lambda: S.sharded_render_compact(compact, cams[0],
                                                       mesh_g, cfg.raster,
                                                       bg))
        out["peaks"]["compact"] = peak()
        errs["compact"] = slab_errors(got, *ref)
        if on_card:
            out["ms"]["sharded_render_compact"] = cuda_ms(
                lambda: S.sharded_render_compact(compact, cams[0], mesh_g,
                                                 cfg.raster, bg), MD_TIMED)
        del compact
        reset_peak()
        built, d_ovf = counted(lambda: S.distributed_shard_compact(
            store, cams[0], mesh_g))
        got = counted(lambda: S.sharded_render_compact(built, cams[0], mesh_g,
                                                       cfg.raster, bg))
        out["peaks"]["distributed"] = peak()
        errs["distributed"] = slab_errors(got, *ref)
        if on_card:
            out["ms"]["distributed build + render"] = cuda_ms(
                lambda: S.sharded_render_compact(S.distributed_shard_compact(
                    store, cams[0], mesh_g)[0], cams[0], mesh_g, cfg.raster,
                    bg), MD_TIMED)
        del built
        frames, reshards = counted(lambda: S.sharded_render_trajectory(
            store, stack_cameras(cams), N_CAMS, mesh_g, cfg.raster, bg))
        errs["trajectory"] = (max(float((frames[f].cpu() - frames_ref[f])
                                        .abs().max())
                                  for f in range(N_CAMS)), 0.0, 0.0)
    out.update(errs=errs, launches=launches, reshards=reshards,
               want_reshards=expected_reshards(cams, radius),
               overflow=(bool(c_ovf), bool(d_ovf)))
    return out


def multi_device_point(P, card: str) -> tuple[dict, dict]:
    """The parallel layer on one NCCL rank and on MD_RANKS gloo ranks
    sharing the card; kernels 1-3 against their plain versions at a
    slab's shapes, kernel 4 and the preprocess backward at a DP rank's."""
    import torch.distributed as dist

    from autovfx_tpu_torch.parallel import launch
    from autovfx_tpu_torch.parallel import sharding as S

    ops = P.ops
    t0 = time.perf_counter()
    cams, target, cfg, images, start = training_setup(P)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(MD_ONE_RANK, store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            launches, times = one_nccl_rank(P, card, cams, target, cfg,
                                            images, start)
        finally:
            dist.destroy_process_group()

    rng = np.random.default_rng(12)
    slab, _ = S.shard_gaussians_compact(target, cams[0], MD_RANKS, 0)
    what = f"slab 0 of {MD_RANKS} ({slab.capacity} rows)"
    err = check_view_kernels(P, slab, cams[0], cfg.raster.dup_budget, TILE,
                             rng, what)
    tx, ty = ops.projection.num_tiles(WIDTH, HEIGHT, TILE)
    tiles = torch.from_numpy(rng.choice(tx * ty, CHECK_TILES,
                                        replace=False)).to(DEVICE)
    cam = cams[MD_DP_CAMERAS[1]]
    what_bwd = f"a DP rank's step ({CAPACITY} slots, camera {MD_DP_CAMERAS[1]})"
    err["preprocess_bwd"], _ = check_preprocess_bwd(P, start, cam, TILE, rng,
                                                    what_bwd)
    err["blend_bwd"], _, zeroed, n_px = check_blend_bwd(
        P, start, cam, TILE, rng, what_bwd, tiles=tiles)
    sync()
    print(f"checks at {what} and {what_bwd}: kernels 1-3, kernel 4 "
          f"({zeroed} of {n_px} pixels zeroed) and the preprocess backward "
          f"against their plain versions: ok (max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in err.items()) + ")")
    budget = cfg.raster.dup_budget
    del cams, target, images, start, slab
    torch.cuda.empty_cache()  # the ranks share the card

    t1 = time.perf_counter()
    constants = {k: globals()[k] for k in (
        "DEVICE", "N_SPLATS", "CAPACITY", "EXTENT", "WIDTH", "HEIGHT",
        "N_CAMS", "TILE")}
    ranks = launch.spawn(MD_RANKS, multi_device_rank,
                         ({"budget": budget, "constants": constants},),
                         backend="gloo", device=DEVICE)
    ranks_s = time.perf_counter() - t1
    dp = ranks[0]["dp"]
    for r, res in enumerate(ranks):
        for name, e in res["errs"].items():
            check_slab(e, f"rank {r} of {MD_RANKS}, {name} slabs")
        check(res["reshards"] == res["want_reshards"],
              f"rank {r}: {res['reshards']} slab builds, the rule's "
              f"{res['want_reshards']}")
        check(not any(res["overflow"]), f"rank {r}: slab overflow "
              f"{res['overflow']}")
        check_launches(res["launches"], slab_paths_launches(N_CAMS),
                       f"multi-device, gloo rank {r}")
        pk = res["peaks"]
        check(pk["compact"] < pk["full"] and pk["distributed"] < pk["full"],
              f"rank {r}: peak memory {pk}: the compact or distributed "
              "slabs do not stay below the full-capacity ones")
        for k, n in res["launches"].items():
            launches[k] += n
    gib = lambda b: b / 2**30
    print(f"multi-device, {MD_RANKS} gloo ranks on one card ({ranks_s:.1f} s "
          f"with their start): the DP step over cameras {MD_DP_CAMERAS}: "
          f"loss {dp['loss']:.6f} vs the mean {dp['want_loss']:.6f}, the "
          f"state within {dp['worst']:.2g} of each field's largest of one "
          f"apply_adam on the mean gradient ({dp['flips']} of "
          f"{dp['n_params']} mean gradients of another sign); slabs against "
          f"rasterize, max color/depth/alpha err: "
          + "; ".join(f"{k} " + "/".join(f"{x:.2g}" for x in e)
                      for k, e in ranks[0]["errs"].items())
          + f"; {ranks[0]['reshards']} slab builds over the ring (the "
          f"rule's); no overflow: ok")
    print(f"[{card}] peak device memory a rank (full-capacity / compact / "
          "distributed slabs, each path with only its inputs held): "
          + "; ".join(f"rank {r} " + " / ".join(
              f"{gib(res['peaks'][k]):.3f}" for k in (
                  "full", "compact", "distributed")) + " GiB"
              for r, res in enumerate(ranks)))
    print(f"[{card}] four ranks on one card, not a scaling figure (rank 0, "
          f"median of {MD_TIMED}, CUDA events): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ranks[0]["ms"].items()))
    print(f"multi-device point: {time.perf_counter() - t0:.1f} s")
    return path_counts(launches), err


# ---- dataset tooling point ---------------------------------------------------
#
# The capture tooling on the bench scene: the ring written as a COLMAP
# model named ``garden`` (so the reader applies the Garden scene's
# calibrated up vector), read back, the scene moved into the reader's
# frame, the 8 depths rendered and their normals, the gravity found
# again from the ground disc's normals, the scene scale from the table's
# mesh and silhouette, and a 60-frame orbit written, reloaded and
# rendered.
NORMAL_TOL = 1e-5  # card against the CPU, and |n| against 1
# The clutter hides the ground disc from the ring (no pixel of a ring
# view of the 200,000-splat scene is 99 % disc), so the disc's splats
# (make_garden_like's first half) are rendered alone for its normals; a
# ground pixel is one they cover to alpha OPAQUE_ALPHA.
OPAQUE_ALPHA = 0.99
RANSAC_ITERS, RANSAC_SAMPLES = 100, 10_000
# The recovered up must lie inside the RANSAC's own inlier cone (cos 0.99,
# alignment.py) about the true one: the disc is a 5 cm thick layer of
# 4-20 mm splats (z × 0.02 of its 2.67 m spread), so its depth normals
# scatter widely about the up.  The aligned ring's heights (all 1.4 m in
# the scene's frame) then spread by at most sin(tilt) / sqrt(2) of its
# radius.
UP_COS_MIN = 0.99
LEVEL_STD_MAX = float(np.sqrt(1.0 - UP_COS_MIN**2) / np.sqrt(2.0))
TRAJ_FRAMES = 60
TRAJ_COVER_MIN = 0.5  # mean alpha of each orbit frame
SCALE_RTOL = 1e-4


def ray_hits_f64(origin, dirs, verts, faces):
    """(R,) float64 distance to the first triangle each ray hits (inf on a
    miss): Möller-Trumbore one triangle at a time, in float64."""
    best = np.full(len(dirs), np.inf)
    for a, b, c in verts[faces].astype(np.float64):
        e1, e2 = b - a, c - a
        p = np.cross(dirs, e2)
        det = p @ e1
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / det
            tv = origin - a
            u = (p @ tv) * inv
            q = np.cross(tv, e1)
            v = (dirs @ q) * inv
            t = (q @ e2) * inv
        ok = (np.abs(det) > 1e-9) & (u >= 0) & (v >= 0) & (u + v <= 1) & (
            t > 1e-6)
        best = np.where(ok & (t < best), t, best)
    return best


def dataset_tools_point(P, card: str) -> dict:
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.core import cameras as C
    from autovfx_tpu_torch.core.quaternion import rotmat_to_quat
    from autovfx_tpu_torch.dataset import alignment, mono_normal, readers
    from autovfx_tpu_torch.dataset import scene_scale, trajectories
    from autovfx_tpu_torch.edit.mesh_io import Mesh
    from autovfx_tpu_torch.perception.gpt4v import estimate_object_scale
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    ops = P.ops
    seconds = {}

    @contextlib.contextmanager
    def stage(name: str):
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        seconds[name] = time.perf_counter() - t0

    g = make_garden_like(N_SPLATS, seed=0, extent=EXTENT, device=DEVICE)
    cams = bench.ring_cameras(WIDTH, HEIGHT, N_CAMS, DEVICE)
    rgb8 = torch.round(torch.clamp(g.sh_dc * SH_C0 + 0.5, 0, 1) * 255).to(
        torch.uint8)
    with tempfile.TemporaryDirectory() as root:
        garden = os.path.join(root, "garden")
        write_colmap_model(os.path.join(garden, "sparse", "0"), cams,
                           g.xyz.cpu().numpy(), rgb8.cpu().numpy())
        sync()
        P.utils.trace.reset()
        with stage("read_360"):
            dc = readers.read_360(garden)
            rcams = readers.to_cameras(dc, WIDTH, HEIGHT, device=DEVICE)
        # the reader's frame, recomputed: the Garden up vector onto +z,
        # the centers zero-mean over 1.1 × their farthest
        r = alignment.up_alignment_rotation(np.asarray(
            readers.SCENE_UP_VECTORS["360"]["garden"]))
        centers = np.stack([c.center.double().cpu().numpy() for c in cams])
        centers = centers @ r.T
        mean = centers.mean(0)
        radius = 1.1 * float(np.linalg.norm(centers - mean, axis=1).max())
        want = np.stack([np.concatenate(
            [r @ c.c2w.double().cpu().numpy()[:3, :3],
             ((x - mean) / radius)[:, None]], 1)
            for c, x in zip(cams, centers)])
        check(dc.names == [f"view_{i}.png" for i in range(N_CAMS)]
              and np.abs(dc.c2w - want).max() < 1e-6
              and np.allclose(dc.K[[0, 1, 0, 1], [0, 1, 2, 2]], [
                  float(cams[0].fx), float(cams[0].fy), float(cams[0].cx),
                  float(cams[0].cy)]),
              f"read_360: poses off by {np.abs(dc.c2w - want).max():.3g}")
        q = rotmat_to_quat(torch.tensor(r, dtype=torch.float32)).to(DEVICE)
        g_r = g.transformed(scale=1.0 / radius, rotation_quat=q,
                            translation=torch.tensor(-mean / radius,
                                                     dtype=torch.float32,
                                                     device=DEVICE),
                            pivot=torch.zeros(3, device=DEVICE))
        with stage("depths"):
            worst = max(int(ops.binning.required_budget(
                ops.preprocess_cuda.preprocess(g_r, C.index_camera(rcams, i),
                                               tile=TILE)))
                for i in range(N_CAMS))
            config = P.RasterConfig(dup_budget=ops.binning.round_budget(
                worst, slack=BUDGET_SLACK), tile=TILE)
            outs = [P.rasterize(g_r, C.index_camera(rcams, i), config=config)
                    for i in range(N_CAMS)]
            sync()
        check(not any(bool(o.overflow) for o in outs), "depths: overflow")
        with stage("normals"):
            normals = [mono_normal.normals_from_depth(
                o.depth, C.index_camera(rcams, i)) for i, o in enumerate(outs)]
            sync()
        disc = dataclasses.replace(g_r, active=g_r.active & (torch.arange(
            g_r.capacity, device=DEVICE) < N_SPLATS // 2))
        with torch.no_grad():
            grounds = [P.rasterize(disc, C.index_camera(rcams, i),
                                   config=config) for i in range(N_CAMS)]
        with stage("ground normals"):
            ground_normals = [mono_normal.normals_from_depth(
                o.depth, C.index_camera(rcams, i))
                for i, o in enumerate(grounds)]
            sync()
        n_err, ground = 0.0, []
        for i, (o, n) in enumerate(zip(outs + grounds,
                                       normals + ground_normals)):
            cam_i = C.index_camera(rcams, i % N_CAMS)
            cpu_cam = dataclasses.replace(cam_i, **{
                f: getattr(cam_i, f).cpu() for f in ("R", "t", "fx", "fy",
                                                     "cx", "cy")})
            want_n = mono_normal.normals_from_depth(o.depth.cpu(), cpu_cam)
            n_err = max(n_err, float((n.cpu() - want_n).abs().max()))
            norm = torch.linalg.norm(n, dim=-1)
            lit = norm > 0.5
            check(float((norm[lit] - 1).abs().max()) <= NORMAL_TOL
                  and float(n[..., 2].max()) <= 0.0,
                  f"view {i}: normals not unit or not inward")
            if i >= N_CAMS:  # a ground view
                on = (o.alpha > OPAQUE_ALPHA) & lit
                ground.append((n[on] @ cam_i.R).cpu().numpy())  # R^T n
        check(n_err <= NORMAL_TOL, f"normals: card vs CPU {n_err:.3g}")
        ground = np.concatenate(ground)
        with stage("gravity"):
            up = alignment.ransac_mean_normal(ground, iters=RANSAC_ITERS,
                                              sample_size=RANSAC_SAMPLES)
            rot = alignment.up_alignment_rotation(up)
            c2w4 = np.concatenate([dc.c2w, np.tile([[[0, 0, 0, 1.0]]],
                                                   (N_CAMS, 1, 1))], 1)
            poses, rot_f32, scale = alignment.normalize_poses(c2w4, up)
        true_up = r @ np.array([0.0, 0.0, 1.0])
        cos = float(up @ true_up)
        heights = poses[:, 2, 3]
        level = float(heights.std() / np.linalg.norm(poses[:, :2, 3],
                                                     axis=1).mean())
        check(len(ground) > RANSAC_SAMPLES and cos >= UP_COS_MIN
              and np.abs(rot @ up - [0, 0, 1]).max() < 1e-6
              and level <= LEVEL_STD_MAX
              and np.abs(poses[:, :3, 3]).max() <= 1.0 + 1e-6,
              f"gravity: {len(ground)} ground normals, cos {cos:.5f} to the "
              f"true up, the aligned ring's heights spread {level:.3g}")

        # the scene scale: camera 0, the edit program's table box and its
        # silhouette (the hull of its corners' projections)
        verts, faces, _ = table_geometry()
        cam0 = cams[0]
        uv, _ = cam0.project(torch.tensor(verts, device=DEVICE))
        mask = in_polygon(convex_hull(uv.cpu().numpy().astype(np.float64)),
                          HEIGHT, WIDTH, 0.0).numpy()
        with stage("scene_scale"):
            scale_got = scene_scale.estimate_scene_scale(
                cam0, Mesh(verts, faces), {"table": mask})
        ys, xs = np.nonzero(mask[::4, ::4])
        dirs = cam0.ray_directions().double().cpu().numpy()[ys * 4, xs * 4]
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        o = cam0.center.double().cpu().numpy()
        t = ray_hits_f64(o, dirs, verts, faces)
        hit = np.isfinite(t)
        pts = o + dirs[hit] * t[hit, None]
        scale_want = float(np.linalg.norm(pts.max(0) - pts.min(0))
                           / estimate_object_scale(None, "table"))
        check(hit.sum() >= 4 and abs(scale_got - scale_want)
              <= SCALE_RTOL * scale_want,
              f"scene scale {scale_got} vs {scale_want} (plain)")

        # a 60-frame orbit at the Garden intrinsics, written, reloaded and
        # rendered
        with stage("trajectory"):
            orbit = trajectories.half_sphere_trajectory(
                [0.0, 0.0, 0.2], 2.6, 1.2, num_frames=TRAJ_FRAMES,
                device=DEVICE)
            path = os.path.join(root, "custom_camera_path", "orbit.json")
            trajectories.save_trajectory(path, orbit)
            back, _, names = C.load_custom_trajectory(path, device=DEVICE)
            worst = max(int(ops.binning.required_budget(
                ops.preprocess_cuda.preprocess(g, C.index_camera(back, i),
                                               tile=TILE)))
                for i in range(TRAJ_FRAMES))
            tconfig = P.RasterConfig(dup_budget=ops.binning.round_budget(
                worst, slack=BUDGET_SLACK), tile=TILE)
            frames = [P.rasterize(g, C.index_camera(back, i), config=tconfig)
                      for i in range(TRAJ_FRAMES)]
            sync()
        launches = bench.kernel_launches()
    renders = 2 * N_CAMS + TRAJ_FRAMES  # depths, the disc's, the orbit
    check_launches(launches, {  # and a preprocess to size each budget
        "preprocess": renders + N_CAMS + TRAJ_FRAMES,
        "duplicate_with_keys": renders, "blend_fwd": renders},
        "dataset tooling")
    traj_err = max(float((getattr(back, f) - getattr(orbit, f)).abs().max())
                   for f in ("R", "t", "fx", "fy", "cx", "cy"))
    check(traj_err <= 1e-6 and len(names) == TRAJ_FRAMES
          and (back.width, back.height) == (1296, 840)
          and not any(bool(f.overflow) for f in frames)
          and all(bool(torch.isfinite(f.color).all()) for f in frames)
          and min(float(f.alpha.mean()) for f in frames) > TRAJ_COVER_MIN,
          f"trajectory: reloaded off by {traj_err:.3g}, or a frame "
          "overflowed, is not finite or is mostly empty")
    print(f"dataset tooling: read_360 equals the recomputed Garden frame; "
          f"normals of the {N_CAMS} depths of the scene and of its ground "
          f"disc alone on the card within {n_err:.2g} of the CPU, unit and "
          f"inward; {len(ground)} ground normals give an "
          f"up {np.degrees(np.arccos(min(cos, 1.0))):.3f} deg from the true "
          f"one, the aligned ring level to {level:.2g} of its radius; scene "
          f"scale {scale_got:.6f} (plain {scale_want:.6f}); a "
          f"{TRAJ_FRAMES}-frame orbit reloaded within {traj_err:.2g} and "
          f"rendered; launches {launches}: ok")
    print(f"[{card}] dataset tooling stages (wall s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return path_counts(launches)


# ---- from-scratch training -------------------------------------------------
#
# ``python -m autovfx_tpu_torch.train_at_scale`` at its default width
# (300,000 ground-truth splats, 1296×840, 24 views) for a few hundred
# steps: too few to densify; the whole 7,000-step curve is a run of its
# own.
SCALE_SPLATS, SCALE_VIEWS, SCALE_ITERS = 300_000, 24, 300


def train_at_scale_point(P, card: str) -> dict:
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch import train_at_scale as TS
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    args = ["--splats", str(SCALE_SPLATS), "--iters", str(SCALE_ITERS),
            "--width", str(WIDTH), "--height", str(HEIGHT), "--views",
            str(SCALE_VIEWS), "--device", DEVICE]
    # the start's PSNR, on train_at_scale's own scene and views
    gt_model = make_garden_like(SCALE_SPLATS, extent=TS.EXTENT, device=DEVICE)
    cams = TS.ring(SCALE_VIEWS, WIDTH, HEIGHT, DEVICE)
    cfg = TS.raster_config(SCALE_SPLATS)
    gt = TS.ground_truth(gt_model, cams, cfg)
    start = TS.mean_psnr(TS.initial_gaussians(gt_model), cams, gt, cfg)
    del gt_model, gt
    sync()
    P.utils.trace.reset()
    t0 = time.perf_counter()
    result = TS.main(args)
    sync()
    wall = time.perf_counter() - t0
    launches = bench.kernel_launches()
    renders = 2 * SCALE_VIEWS  # the ground truth and the final PSNR
    check_launches(launches, {
        "preprocess": renders + SCALE_ITERS,
        "duplicate_with_keys": renders + SCALE_ITERS,
        "blend_fwd": renders, "blend_fwd_train": SCALE_ITERS,
        "blend_bwd": SCALE_ITERS, "preprocess_bwd": SCALE_ITERS},
        "train_at_scale")
    check(result["final_psnr"] > start
          and all(np.isfinite(h["loss"]) for h in result["history"]),
          f"train_at_scale: PSNR {start:.3f} -> {result['final_psnr']}")
    print(f"[{card}] train_at_scale ({SCALE_ITERS} steps; its own CUDA "
          f"events): {result['value']} iters/s, PSNR {start:.3f} -> "
          f"{result['final_psnr']} dB, {result['active_splats']} active; "
          f"the call {wall:.1f} s wall: ok")
    return path_counts(launches)


# ---- the port's bench -------------------------------------------------------

BENCH_TIMEOUT_S = 900
FORWARD = ("preprocess", "duplicate_with_keys", "blend_fwd")
# the kernels each stage of the bench runs (and no others)
BENCH_STAGE_KERNELS = {"novel view": FORWARD, "edited frame": FORWARD,
                       "physics": (), "effects frame": FORWARD,
                       "replay": FORWARD, "train": TRAIN_LIKE,
                       "sugar": FORWARD}
BENCH_KEYS = ("value", "vs_baseline", "dup_budget", "novel_view_fps",
              "physics_steps_per_sec", "edit_effects_fps", "smoke_res",
              "edit_replay_fps", "edit_replay_wall_s", "train_iters_per_sec",
              "sugar_extract_seconds", "sugar_vertices",
              "sugar_rms_to_levelset")


def bench_point(P, card: str) -> dict:
    """``python -m autovfx_tpu_torch.bench`` in a subprocess, in every mode
    at once (``BENCH_MODE=all``) and at the JAX package's bench.py
    defaults: its exit, every key of its last line finite and positive,
    the SuGaR mesh within its vertex target and nearer the level than
    as many uniform points in the foreground box, and each stage's kernel
    launches (its ``#`` lines); its lines re-printed here.  Returns the
    run's launches by kernel."""
    from autovfx_tpu_torch import bench
    from autovfx_tpu_torch.core.cameras import stack_cameras
    from autovfx_tpu_torch.utils.synthetic import make_garden_like

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["BENCH_MODE"] = "all"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "autovfx_tpu_torch.bench"],
                       cwd=HERE, env=env, capture_output=True, text=True,
                       timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = r.stdout.splitlines()
    for line in out:
        print(f"bench: {line}")
    check(r.returncode == 0 and out, f"the bench exited {r.returncode}: "
          f"{r.stderr[-3000:]}")
    last = json.loads(out[-1])
    for k in BENCH_KEYS:
        check(k in last and np.isfinite(last[k]) and last[k] > 0,
              f"the bench's last line: {k} = {last.get(k)}")
    defaults = bench.Settings()
    check(last["smoke_res"] == defaults.smoke_res
          and last["sugar_vertices"] <= defaults.sugar_verts,
          f"the bench's sizes: {last}")
    # the level set's RMS against uniform points in the foreground box
    # (PERF.md §2), as many as the statistic read of the mesh
    g = make_garden_like(defaults.gaussians, seed=0, extent=defaults.extent,
                         device=DEVICE)
    v = last["sugar_vertices"]
    n_sel = len(range(0, v, max(v // bench.RMS_VERTICES, 1)))
    centers = stack_cameras(
        bench.ring_cameras(WIDTH, HEIGHT, N_CAMS, DEVICE)).center.cpu().numpy()
    c_ext = np.maximum(centers.max(0) - centers.min(0), 0.5)
    mid = (centers.min(0) + centers.max(0)) / 2
    box = np.random.default_rng(7).uniform(mid - 1.05 * c_ext,
                                           mid + 1.05 * c_ext, (n_sel, 3))
    rms_box = bench.rms_to_levelset(g, box)
    check(last["sugar_rms_to_levelset"] < rms_box,
          f"the bench's sugar_rms_to_levelset {last['sugar_rms_to_levelset']}"
          f" is not below the foreground box's uniform points' {rms_box:.4f}")
    # each stage's launches: its own kernels, each at least once
    stages = {}
    for line in out:
        m = re.match(r"# (.+?): .* launches (\{.*\})$", line)
        if m:
            stages[m.group(1)] = json.loads(m.group(2))
    check(set(stages) == set(BENCH_STAGE_KERNELS),
          f"the bench's stages: {sorted(stages)}")
    launches = dict.fromkeys(KERNELS, 0)
    for name, counts in stages.items():
        for k, n in counts.items():
            check((n > 0) == (k in BENCH_STAGE_KERNELS[name]),
                  f"the bench's {name}: {k} launched {n} times")
        for k, n in path_counts(counts).items():
            launches[k] += n
    print(f"[{card}] the bench (python -m autovfx_tpu_torch.bench, "
          f"BENCH_MODE=all, bench.py's defaults): rc 0 in {wall:.1f} s; "
          f"every key finite and positive; sugar_rms_to_levelset "
          f"{last['sugar_rms_to_levelset']} below uniform points' "
          f"{rms_box:.4f} ({n_sel}); launches by stage {stages}: ok")
    return launches


def physics_point(P, card: str, w, inp, config) -> None:
    """Physics substeps and the whole replay (simulate + render_clip) of
    the edited frame's clip.  Run last: the profiler's sessions after
    its long one lose their first records."""
    from autovfx_tpu_torch.physics import solver, world
    from autovfx_tpu_torch.render import clip

    state = w.state
    for _ in range(WARMUP):
        state, _ = solver.substep(w.shape, state, w.params, w.grid, w.cfg)
    sync()
    substeps = lambda: [solver.substep(w.shape, w.state, w.params, w.grid,
                                       w.cfg) for _ in range(PHYSICS_SUBSTEPS)]
    sub_ms = cuda_ms(substeps, 3)
    # short: the profiler's sessions after a long one lose their first
    # records
    records = profiled(lambda: [solver.substep(w.shape, w.state, w.params,
                                               w.grid, w.cfg)
                                for _ in range(PHYSICS_PROFILED)], 1)
    sub_busy = sum(e.duration_ns() for e in records) / 1e6 / PHYSICS_PROFILED
    t0 = time.perf_counter()
    _, pos, quat = world.simulate(w, N_CAMS)
    traj = world.origin_trajectory(w, pos, quat)
    replay = clip.render_clip(
        dataclasses.replace(inp, traj_pos=torch.from_numpy(traj[0]).to(DEVICE),
                            traj_rot=torch.from_numpy(traj[1]).to(DEVICE)),
        N_CAMS, config, fused=True)
    sync()
    replay_s = time.perf_counter() - t0
    check(bool(torch.isfinite(replay).all()), "replay: not finite")
    print(f"[{card}] physics: {PHYSICS_SUBSTEPS * 1000.0 / sub_ms:.0f} "
          f"substeps/s ({sub_ms / PHYSICS_SUBSTEPS:.3f} ms a substep, CUDA "
          f"events; device busy {sub_busy:.3f} ms in "
          f"{len(records) / PHYSICS_PROFILED:.0f} device records a substep, "
          f"profiler); replay (simulate {N_CAMS} frames + render_clip) "
          f"{replay_s * 1000.0:.1f} ms wall")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is False")
    t_start = time.perf_counter()
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
    print_ptxas((lib.parent / "nvcc.log").read_text())
    _build.load_library()
    # the package needs no global precision setting: its convolutions run
    # in float32 whatever cuDNN's TF32 flag says (utils/conv.py)
    print(f"TF32 flags (PyTorch's defaults, left as they are): cuDNN "
          f"{torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}")

    small_checks(P)
    view_launches, err, ms, perf = operating_point(P, card)
    err.update(small_grad_checks(P))
    train_launches, train_err, (train_ms, train_perf) = training_point(
        P, card)
    edit_launches, edit_err, edit_perf, edit = edited_frame_point(P, card)
    fx_launches, fx_err, fx_perf = effects_frame_point(P, card, edit)
    card_against_cpu(P)
    pano_launches, pano_err = panorama_point(P, card, edit["g"])
    program_launches, program_err = edit_program_point(P, card)
    removal_launches, removal_err = removal_program_point(P, card)
    sugar_launches, sugar_err = sugar_pipeline_point(P, card)
    sugar_card_against_cpu(P)
    field_rows = density_field_point(P, card, sugar_launches)
    md_launches, md_err = multi_device_point(P, card)
    dataset_launches = dataset_tools_point(P, card)
    scale_launches = train_at_scale_point(P, card)
    bench_launches = bench_point(P, card)
    physics_point(P, card, edit["w"], edit["inp"], edit["config"])
    for part in (train_err, edit_err, fx_err, pano_err, program_err,
                 removal_err, sugar_err, md_err):
        for k, e in part.items():
            err[k] = max(err.get(k, 0.0), e)
    ms.update(train_ms)
    for part in (train_perf, edit_perf, fx_perf):
        for k, x in part.items():
            perf.setdefault(k, {}).update(x)
    # each path's own counts; kernel 3 runs its training variant there
    train_launches["blend_fwd"] = train_launches.pop("blend_fwd_train")
    kernels = []
    for k in KERNELS:
        by_path = {"novel_view": view_launches[k],
                   "training": train_launches[k],
                   "edited_frame": edit_launches[k],
                   "effects_frame": fx_launches[k],
                   "panorama": pano_launches[k],
                   "edit_program": program_launches[k],
                   "removal_program": removal_launches[k],
                   "sugar_pipeline": sugar_launches[k],
                   "multi_device": md_launches[k],
                   "dataset_tools": dataset_launches[k],
                   "train_at_scale": scale_launches[k],
                   "bench": bench_launches[k]}
        main = perf[k][MAIN_PATH[k]]
        kernels.append(dict(
            name=k, route="cuda", **KERNELS[k],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=err[k], ms=main["ms"], plain_ms=ms[k][1],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            bound_rate=main["bound_rate"], share=main["share"],
            paths=perf[k]))
    kernels += field_rows
    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
