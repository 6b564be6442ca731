"""Gaussian checkpoints: the vanilla-3DGS binary PLY (numpy parsing), a
SuGaR ``.pt`` and the ``.npz`` archive.

Counterpart of ``autovfx_tpu/core/ply_io.py``; the PLY files are
byte-identical in both directions.  Properties are
x,y,z,nx,ny,nz,f_dc_{0..2},f_rest_{0..3*(K-1)-1},opacity,scale_{0..2},
rot_{0..3} as little-endian float32; f_rest is channel-major.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core.gaussians import Gaussians

_HEADER_RE = re.compile(rb"end_header\n")


def _build_dtype(num_rest: int) -> np.dtype:
    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(num_rest)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    return np.dtype([(n, "<f4") for n in names])


def save_ply(path: str, g: Gaussians, compact: bool = True) -> None:
    """Write a binary PLY; ``compact`` drops inactive slots."""
    arr = lambda x: x.detach().cpu().numpy()
    keep = arr(g.active) if compact else np.ones(g.capacity, bool)
    take = lambda x: arr(x)[keep]
    xyz = take(g.xyz)
    n = xyz.shape[0]
    k_rest = g.sh_rest.shape[1]
    dtype = _build_dtype(3 * k_rest)
    data = np.zeros(n, dtype=dtype)
    data["x"], data["y"], data["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    sh_dc = take(g.sh_dc)
    for i in range(3):
        data[f"f_dc_{i}"] = sh_dc[:, i]
    # channel-major flatten of (N, K-1, 3) -> (N, 3, K-1)
    rest = take(g.sh_rest).transpose(0, 2, 1).reshape(n, -1)
    for i in range(3 * k_rest):
        data[f"f_rest_{i}"] = rest[:, i]
    data["opacity"] = take(g.opacity_logit)
    log_scales = take(g.log_scales)
    for i in range(3):
        data[f"scale_{i}"] = log_scales[:, i]
    quats = take(g.quats)
    for i in range(4):
        data[f"rot_{i}"] = quats[:, i]

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {name}\n" for name in dtype.names)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())


def _parse_ply_header(raw: bytes):
    end = _HEADER_RE.search(raw)
    if end is None:
        raise ValueError("not a PLY file (no end_header)")
    lines = raw[: end.end()].decode("ascii").strip().split("\n")
    if lines[0] != "ply":
        raise ValueError("not a PLY file")
    fmt = next(line for line in lines if line.startswith("format"))
    if "binary_little_endian" not in fmt:
        raise ValueError(f"unsupported PLY format: {fmt}")
    count = None
    props = []
    in_vertex = False
    for line in lines:
        if line.startswith("element"):
            _, name, cnt = line.split()
            in_vertex = name == "vertex"
            if in_vertex:
                count = int(cnt)
        elif line.startswith("property") and in_vertex:
            _, ptype, pname = line.split()
            if ptype not in ("float", "float32"):
                raise ValueError(f"unsupported property type {ptype}")
            props.append(pname)
    return count, props, end.end()


def load_ply(path: str, device=devices.DEFAULT) -> Gaussians:
    """Read a binary PLY into ``Gaussians`` on ``device``."""
    device = devices.resolve(device)
    with open(path, "rb") as f:
        raw = f.read()
    count, props, offset = _parse_ply_header(raw)
    dtype = np.dtype([(p, "<f4") for p in props])
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)

    cols = lambda names: np.stack([data[p] for p in names], axis=1)
    rest_names = sorted(
        (p for p in props if p.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    k_rest = len(rest_names) // 3
    if rest_names:
        sh_rest = cols(rest_names).reshape(count, 3, k_rest).transpose(0, 2, 1)
    else:
        sh_rest = np.zeros((count, 0, 3), np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Gaussians(
        xyz=t(cols(["x", "y", "z"])),
        sh_dc=t(cols([f"f_dc_{i}" for i in range(3)])),
        sh_rest=t(sh_rest),
        log_scales=t(cols([f"scale_{i}" for i in range(3)])),
        quats=t(cols([f"rot_{i}" for i in range(4)])),
        opacity_logit=t(data["opacity"]),
        active=torch.ones(count, dtype=torch.bool, device=device),
    )


def load_sugar_pt(path: str, device=devices.DEFAULT) -> Gaussians:
    """Read a SuGaR ``.pt`` checkpoint straight into tensors on
    ``device``: ``_points`` (N, 3), ``all_densities`` (N, 1) opacity
    logits, ``_sh_coordinates_dc`` (N, 1, 3), ``_sh_coordinates_rest``
    (N, K-1, 3), ``_scales`` (N, 3) log-scales, ``_quaternions`` (N, 4),
    at the top level or under ``state_dict``."""
    device = devices.resolve(device)
    ckpt = torch.load(path, map_location=device, weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    f32 = lambda key: sd[key].detach().to(device=device,
                                          dtype=torch.float32)
    xyz = f32("_points")
    n = xyz.shape[0]
    return Gaussians(
        xyz=xyz.contiguous(),
        sh_dc=f32("_sh_coordinates_dc").reshape(n, 3).contiguous(),
        sh_rest=f32("_sh_coordinates_rest").contiguous(),
        log_scales=f32("_scales").contiguous(),
        quats=f32("_quaternions").contiguous(),
        opacity_logit=f32("all_densities").reshape(-1).contiguous(),
        active=torch.ones(n, dtype=torch.bool, device=device),
    )


def load_gaussians(path: str, device=devices.DEFAULT) -> Gaussians:
    """A checkpoint by its extension: ``.pt`` (SuGaR), ``.ply`` or
    ``.npz``."""
    if path.endswith(".pt"):
        return load_sugar_pt(path, device=device)
    if path.endswith(".ply"):
        return load_ply(path, device=device)
    if path.endswith(".npz"):
        return load_npz(path, device=device)
    raise ValueError(f"unsupported gaussian checkpoint: {path}")


def save_npz(path: str, g: Gaussians) -> None:
    """Every field, inactive slots included, in one compressed archive."""
    np.savez_compressed(path, **{
        f.name: getattr(g, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(g)})


def load_npz(path: str, device=devices.DEFAULT) -> Gaussians:
    device = devices.resolve(device)
    with np.load(path) as z:
        return Gaussians(**{f.name: torch.from_numpy(z[f.name]).to(device)
                            for f in dataclasses.fields(Gaussians)})
