"""Build the package's CUDA kernels with nvcc and load them with ctypes.

All ``csrc/*.cu`` files compile into one shared library with a plain C
interface, at first use, into ``build/kernels/<hash>/`` beside the
package (the hash covers the sources and the flags, so an edited kernel
rebuilds).  Each file compiles to an object with ``NVCC_FLAGS`` plus its
entry in ``FILE_FLAGS``, all files at once, and one ``nvcc -shared``
links them.  Nothing here runs when the module is imported, and a CPU
tensor never reaches ``load_library``: the wrappers call it only on the
path that launches a kernel.

Every C entry returns ``cudaGetLastError()`` after its launch; ``check``
turns a nonzero code into an exception, because a refused launch never
runs and ``torch.cuda.synchronize()`` would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libautovfx_kernels.so"
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"  # where the CUDA toolkit puts it
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # per-kernel registers / spills, kept in nvcc.log
)
# The preprocess is held to float32 parity with its plain version
# (rel 1e-5 on the conic, 1e-4 px on mean2d): without contraction into
# FMA it rounds every product and sum as the unfused tensor ops do.  Its
# backward recomputes the forward's determinant and is built the same
# way, so the gradients through the conic start from the same numbers.
FILE_FLAGS = {"preprocess.cu": ("-fmad=false",),
              "preprocess_bwd.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float

# argtypes of every C entry; pointers and the stream are c_void_p
SIGNATURES = {
    "preprocess_fwd": [
        _I,  # n
        _P, _P, _P, _I, _I,  # xyz, sh_dc, sh_rest, k_rest, degree
        _P, _P, _P, _P,  # log_scales, quats, opacity_logit, active
        _P, _P,  # override_color, mean2d_offset (both nullable)
        _P, _F,  # cam params, scaling_modifier
        _I, _I, _I,  # tile, tiles_x, tiles_y
        _P, _P, _P, _P, _P,  # mean2d, conic, opacity, color, depth
        _P, _P, _P, _P,  # radius, tile_min, tile_max, tiles_touched
        _P,  # stream
    ],
    "preprocess_bwd": [
        _I,  # n
        _P, _P, _P, _I, _I,  # xyz, sh_dc, sh_rest, k_rest, degree
        _P, _P, _P, _P,  # log_scales, quats, opacity_logit, tiles_touched
        _I, _P, _F,  # sh_color (0 with an override color), cam, modifier
        _P, _I64, _P, _I64,  # g mean2d, conic, each with its row stride
        _P, _I64, _P, _I64, _P, _I64,  # g opacity, color, depth, the same
        _P, _P, _P, _P, _P, _P,  # d xyz, sh_dc, sh_rest, log_scales,
        #                          quats, opacity_logit
        _P,  # stream
    ],
    "duplicate_with_keys": [
        _I,  # n
        _P, _P, _P, _P, _P,  # tiles_touched, starts, tile_min, tile_max, depth
        _I, _I, _I64,  # tiles_x, n_tiles, budget
        _P, _P,  # keys, gids (every slot below the budget written)
        _P,  # stream
    ],
    "blend_fwd": [
        _P, _P,  # tile_range, gid
        _P, _P, _P, _P, _P,  # mean2d, conic, opacity, color, depth
        _I, _I, _I, _I, _I,  # n_tiles, tiles_x, tile, width, height
        _P, _P, _P,  # out color, depth, alpha
        _P,  # stream
    ],
    "blend_fwd_train": [
        _P, _P,  # tile_range, gid
        _P, _P, _P, _P, _P,  # mean2d, conic, opacity, color, depth
        _I, _I, _I, _I, _I,  # n_tiles, tiles_x, tile, width, height
        _P, _P, _P,  # out color, depth, alpha
        _P, _P,  # out final_T, n_contrib
        _P,  # stream
    ],
    "blend_bwd": [
        _P, _P,  # tile_range, gid
        _P, _P, _P, _P, _P,  # mean2d, conic, opacity, color, depth
        _P, _P,  # final_T, n_contrib
        _P, _P, _P,  # g color, depth, alpha (images)
        _I, _I, _I, _I, _I,  # n_tiles, tiles_x, tile, width, height
        _P,  # grad (N, 10), zeroed by the caller
        _P,  # stream
    ],
    "density_fwd": [
        _I64, _I,  # points, neighbours a point
        _P, _P, _P,  # points (P, 3), neighbours (P, k) int32, table (N, 12)
        _P, _P,  # out density (P,), gradient (P, 3)
        _P,  # stream
    ],
    "density_bwd": [
        _I64, _I,  # points, neighbours a point
        _P, _P, _P,  # points, neighbours, table, as the forward's
        _P, _P,  # g density, g gradient (both nullable)
        _P, _P,  # d points (nullable), d table (N, 12), zeroed by the caller
        _P,  # stream
    ],
}

_lock = threading.Lock()
_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or NVCC_FALLBACK
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(repr((NVCC_FLAGS, sorted(FILE_FLAGS.items()))).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library unless this source hash is already built."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    log = []
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
        objs, cmds = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp_dir, src.stem + ".o")
            cmds.append([nvcc, *NVCC_FLAGS, *FILE_FLAGS.get(src.name, ()),
                         "-c", str(src), "-o", obj])
            objs.append(obj)
        _run_all(cmds, log)  # one nvcc per source, all at once
        tmp = os.path.join(tmp_dir, LIB_NAME)
        _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs]], log)
        (out.parent / "nvcc.log").write_text("".join(log))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def _run_all(cmds: list[list[str]], log: list[str]) -> None:
    """Run the commands side by side; raise with the log of the first
    that failed, after every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = None
    for cmd, proc in zip(cmds, procs):
        text, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{text}")
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{log[-1]}"
    if failed:
        raise RuntimeError(failed)


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple):
    """Raise unless ``t`` is what a kernel takes: CUDA, dtype, shape and
    contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rows(t: torch.Tensor, name: str, dtype: torch.dtype,
               shape: tuple) -> int:
    """Like ``check_tensor`` for a tensor that a kernel reads row by row
    at its own row stride, such as a column slice of a wider buffer: its
    columns must be adjacent, its rows need not be.  Returns the row
    stride in elements."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dim() == 2 and t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must have adjacent columns")
    return t.stride(0)
