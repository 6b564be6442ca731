"""The benchmark's inputs, made from ``--seed`` on the run's device.

Both sides get these tensors: the program as its ``Gaussians``,
``Camera`` and clip inputs, the plain reference as they are.  Nothing
here imports the program.

- ``garden``: the Garden-like splat cloud of a configuration's
  ``layout`` (a ground disc, mid-height clutter and a far shell, SH
  degree 3), drawn by a ``torch.Generator`` on the device in a few large
  calls.  The layout is ``utils/synthetic.make_garden_like``'s; the draws
  are torch's, so a seed gives another cloud than numpy's would.
- ``ring``: the configuration's camera ring (OpenCV convention, +z
  forward), as plain numbers.
- ``cube_*``: the edit's inserted cube: its surfels, its hull planes and
  a seeded drop with a bounce onto the ground, one pose a frame.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814
FIELDS = ("xyz", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logit")
GRAVITY = 9.81  # m/s²


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer below
    2**63; larger ones are folded)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _part(n: int, gen, dev, spread: float, scale_range, opacity_range,
          sh_rest: int, sh_std: float) -> dict:
    u = lambda *s: torch.rand(s, generator=gen, device=dev)
    z = lambda *s: torch.randn(s, generator=gen, device=dev)
    lo, hi = scale_range
    op = opacity_range[0] + (opacity_range[1] - opacity_range[0]) * u(n)
    quats = z(n, 4)
    return {
        "xyz": z(n, 3) * spread,
        "sh_dc": (u(n, 3) - 0.5) / SH_C0,
        "sh_rest": sh_std * z(n, sh_rest, 3),
        "log_scales": torch.log(lo + (hi - lo) * u(n, 3)),
        "quats": quats / quats.norm(dim=-1, keepdim=True).clamp(min=1e-12),
        "opacity_logit": torch.log(op / (1.0 - op)),
    }


def garden(cfg: dict, seed: int, device) -> dict:
    """The configuration's splat cloud: a dict of the parameter fields
    and ``active``, float32 on ``device``."""
    dev = torch.device(device)
    gen = generator(seed, dev)
    n, extent = int(cfg["splats"]), float(cfg["extent"])
    k_rest = (int(cfg["sh_degree"]) + 1) ** 2 - 1
    parts, left = [], n
    for i, p in enumerate(cfg["layout"]):
        count = left if i == len(cfg["layout"]) - 1 else n // int(p["divisor"])
        left -= count
        g = _part(count, gen, dev, extent * p["spread"], p["scale_range"],
                  cfg["opacity_range"], k_rest, cfg["sh_rest_std"])
        g["xyz"][:, 2] = g["xyz"][:, 2] * p["z_scale"] + p["z_shift"]
        parts.append(g)
    out = {f: torch.cat([p[f] for p in parts]).contiguous() for f in FIELDS}
    out["active"] = torch.ones(n, dtype=torch.bool, device=dev)
    return out


class View(NamedTuple):
    """A pinhole camera: ``R``, ``t`` world-to-camera (p_cam = R p + t),
    float32 numpy; intrinsics and size as Python numbers."""

    R: np.ndarray
    t: np.ndarray
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def center(self) -> np.ndarray:
        return (-self.R.T.astype(np.float64) @ self.t).astype(np.float32)


def look_at(eye, target, up, fx, fy, width, height) -> View:
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    w2c = np.linalg.inv(c2w)
    return View(R=w2c[:3, :3].astype(np.float32),
                t=w2c[:3, 3].astype(np.float32), fx=float(np.float32(fx)),
                fy=float(np.float32(fy)), cx=float(np.float32(width / 2.0)),
                cy=float(np.float32(height / 2.0)), width=int(width),
                height=int(height))


def ring(cfg: dict) -> list[View]:
    """The configuration's ring: ``views`` cameras at ``radius`` and
    ``height``, looking at ``target``, with the Garden intrinsics scaled
    to ``width``."""
    r = cfg["ring"]
    w, h = int(cfg["width"]), int(cfg["height"])
    s = w / float(cfg["intrinsics_width"])
    return [look_at([r["radius"] * math.cos(a), r["radius"] * math.sin(a),
                     r["height"]], r["target"], [0.0, 0.0, 1.0],
                    cfg["fx"] * s, cfg["fy"] * s, w, h)
            for a in np.linspace(0, 2 * np.pi, r["views"], endpoint=False)]


# ---- the edit's cube -------------------------------------------------------

CUBE_FACE_NORMALS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                              [0, 0, 1], [0, 0, -1]], np.float32)
HULL_SLOTS = 8  # plane slots of the hull; the last two are masked out


def cube_surfels(edit: dict, seed: int, device) -> dict:
    """``edit["surfels"]`` surfels spread uniformly over the cube's six
    faces (equal areas), in the body frame: ``points``, ``normals``,
    ``colors`` (0.7 grey, the material's albedo multiplies it) and the
    0-d ``radius`` that tiles the surface (1.1 √(area / n))."""
    dev = torch.device(device)
    gen = generator(seed + 1, dev)
    n, h = int(edit["surfels"]), float(edit["cube_half"])
    face = torch.randint(0, 6, (n,), generator=gen, device=dev)
    uv = (2.0 * torch.rand((n, 2), generator=gen, device=dev) - 1.0) * h
    nrm = torch.from_numpy(CUBE_FACE_NORMALS).to(dev)[face]
    axis = nrm.abs().argmax(dim=1)
    pts = torch.zeros((n, 3), device=dev)
    pts.scatter_(1, axis[:, None], (nrm.sum(dim=1) * h)[:, None])
    other = torch.stack([(axis + 1) % 3, (axis + 2) % 3], dim=1)
    pts.scatter_(1, other, uv)
    area = 6.0 * (2.0 * h) ** 2
    return {"points": pts, "normals": nrm,
            "colors": torch.full((n, 3), 0.7, device=dev),
            "radius": torch.tensor(math.sqrt(area / n) * 1.1,
                                   dtype=torch.float32, device=dev)}


def cube_hull(edit: dict) -> tuple[np.ndarray, np.ndarray]:
    """(1, 8, 4) body-frame planes n·x <= d of the cube and their (1, 8)
    mask (six real planes)."""
    planes = np.zeros((1, HULL_SLOTS, 4), np.float32)
    planes[0, :6, :3] = CUBE_FACE_NORMALS
    planes[0, :6, 3] = edit["cube_half"]
    mask = np.zeros((1, HULL_SLOTS), bool)
    mask[0, :6] = True
    return planes, mask


def cube_drop(edit: dict, frames: int, seed: int) -> tuple[np.ndarray,
                                                             np.ndarray]:
    """The cube's poses, (F, 1, 3) positions and (F, 1, 3, 3) rotations
    (float32): dropped from ``drop_z`` at a seeded spot within
    ``spot`` m of the ring's axis, falling under gravity onto the ground
    at ``ground_z`` and bouncing with ``restitution``, one pose every
    ``frame_s`` seconds, turning about +z at a seeded rate."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    spot = rng.uniform(-edit["spot"], edit["spot"], 2)
    yaw0, rate = rng.uniform(0, 2 * np.pi), rng.uniform(-2.0, 2.0)
    rest = edit["ground_z"] + edit["cube_half"]
    z, v, e = edit["drop_z"], 0.0, edit["restitution"]
    pos = np.zeros((frames, 1, 3), np.float32)
    rot = np.zeros((frames, 1, 3, 3), np.float32)
    dt, sub = edit["frame_s"], 64
    for f in range(frames):
        pos[f, 0] = (spot[0], spot[1], z)
        a = yaw0 + rate * f * dt
        c, s = math.cos(a), math.sin(a)
        rot[f, 0] = ((c, -s, 0), (s, c, 0), (0, 0, 1))
        for _ in range(sub):  # the fall and bounce between two frames
            v -= GRAVITY * dt / sub
            z += v * dt / sub
            if z < rest:
                z, v = rest + (rest - z) * e, -v * e
    return pos, rot


def envmap(edit: dict, seed: int) -> np.ndarray:
    """The seeded (H, W, 3) float32 envmap, uniform in ``env_range``."""
    rng = np.random.default_rng((int(seed) + 2) % (1 << 63))
    lo, hi = edit["env_range"]
    h, w = edit["env_shape"]
    return (lo + (hi - lo) * rng.random((h, w, 3))).astype(np.float32)
