"""Plain PyTorch coarse SuGaR step with the density regularizer: the 3DGS
loss of a render, the opacity entropy, the near-surface density target
|exp(-d²/2β²) − density| on samples drawn inside the Gaussians (d from
the render's depth and alpha at the sample's pixel, β the mean smallest
scale of its 16 neighbours) and the field-normal consistency, their
gradient (the blend's through the plain blend backward, the rest by
autograd) and Adam.

A frozen copy of the program's plain paths (``sugar/coarse_train``,
``sugar/regularization``, ``sugar/density``, ``ops/knn``'s Morton-window
neighbours) with no import of the program.  The step's render feeds the
photometric loss its color and the regularizer its depth and alpha, one
render for both (the program renders twice, the same splats).
"""
from __future__ import annotations

import torch

from benchmark.reference import raster
from benchmark.reference import train as ref_train

FIELDS = ref_train.FIELDS
CHUNK = 1 << 18
INACTIVE_CODE = 0xFFFFFFFF


# ---- neighbours ----------------------------------------------------------------


def _expand_bits(v):
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    return (v * 0x00000005) & 0x49249249


def knn(xyz: torch.Tensor, mask: torch.Tensor, k: int = 16,
        window: int = 48) -> torch.Tensor:
    """(N, k) neighbours among the active points: the ±``window``
    candidates in Morton order (a 2^10 grid over the active bounding
    box), the k nearest by a stable sort, the point itself included;
    inactive points get themselves."""
    n, dev = xyz.shape[0], xyz.device
    m = mask[:, None]
    lo = torch.where(m, xyz, torch.full_like(xyz, 1e30)).amin(dim=0)
    hi = torch.where(m, xyz, torch.full_like(xyz, -1e30)).amax(dim=0)
    q = torch.clamp(((xyz - lo) / torch.clamp(hi - lo, min=1e-9)) * 1023.0,
                    0.0, 1023.0).to(torch.int64)
    codes = ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
             | _expand_bits(q[:, 2]))
    codes = torch.where(mask, codes, torch.full((n,), INACTIVE_CODE,
                                                device=dev))
    order = torch.argsort(codes, stable=True)
    pts, act = xyz[order], mask[order]
    offs = torch.arange(-window, window + 1, device=dev)
    idx = torch.arange(n, device=dev)[:, None] + offs[None, :]
    idx_c = torch.clamp(idx, 0, n - 1)
    ok = (idx >= 0) & (idx < n) & act[idx_c] & act[:, None]
    d2 = torch.sum((pts[idx_c] - pts[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    top_d2, top_pos = torch.sort(d2, dim=1, stable=True)
    top_d2, top_pos = top_d2[:, :k], top_pos[:, :k]
    nbr = order[torch.gather(idx_c, 1, top_pos)]
    nbr = torch.where(torch.isfinite(top_d2), nbr, order[:, None].expand(n, k))
    out = torch.zeros((n, k), dtype=torch.int64, device=dev)
    out[order] = nbr
    return out


# ---- the field -----------------------------------------------------------------


def _rotmat(q):
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], dim=-2)


def _opacity(g):
    return torch.sigmoid(g["opacity_logit"]) * g["active"].to(torch.float32)


def _inv_cov(g):
    rot = _rotmat(g["quats"])
    inv_s2 = 1.0 / torch.clamp(torch.exp(g["log_scales"]) ** 2, min=1e-12)
    return torch.einsum("nij,nj,nkj->nik", rot, inv_s2, rot)


def density(points, nbrs, g):
    inv_cov, op = _inv_cov(g), _opacity(g)
    out = []
    for s in range(0, points.shape[0], CHUNK):
        nb = nbrs[s:s + CHUNK]
        d = points[s:s + CHUNK, None, :] - g["xyz"][nb]
        mahal = torch.einsum("cki,ckij,ckj->ck", d, inv_cov[nb], d)
        out.append(torch.sum(op[nb] * torch.exp(-0.5 * mahal), dim=-1))
    return torch.cat(out)


def density_gradient(points, nbrs, g):
    inv_cov, op = _inv_cov(g), _opacity(g)
    out = []
    for s in range(0, points.shape[0], CHUNK):
        nb = nbrs[s:s + CHUNK]
        d = points[s:s + CHUNK, None, :] - g["xyz"][nb]
        icd = torch.einsum("ckij,ckj->cki", inv_cov[nb], d)
        w = op[nb] * torch.exp(-0.5 * torch.einsum("cki,cki->ck", d, icd))
        out.append(-torch.sum(w[..., None] * icd, dim=1))
    return torch.cat(out)


def normals(g):
    rot = _rotmat(g["quats"])
    idx = torch.argmin(g["log_scales"], dim=-1)
    return torch.take_along_dim(rot, idx[:, None, None].expand(-1, 3, 1),
                                dim=2)[..., 0]


def regularizer(g, cam: raster.Cam, depth, alpha, draws, s: dict):
    """The SuGaR terms: entropy + density target + normal consistency."""
    o = torch.clamp(_opacity(g), 1e-6, 1 - 1e-6)
    act = g["active"].to(torch.float32)
    ent = -(o * torch.log(o) + (1 - o) * torch.log(1 - o))
    loss = s["entropy_weight"] * torch.sum(ent * act) / torch.clamp(
        act.sum(), min=1.0)
    idx, eps = draws
    rot = _rotmat(g["quats"][idx])
    pts = g["xyz"][idx] + torch.einsum("nij,nj->ni", rot,
                                       torch.exp(g["log_scales"][idx]) * eps)
    nbrs = knn(g["xyz"].detach(), g["active"], k=s["neighbors"])[idx]
    p = torch.einsum("ij,nj->ni", cam.R, pts) + cam.t
    z = p[:, 2]
    u = cam.fx * p[:, 0] / z + cam.cx
    v = cam.fy * p[:, 1] / z + cam.cy
    x = torch.clamp(u.to(torch.int64), 0, cam.width - 1)
    y = torch.clamp(v.to(torch.int64), 0, cam.height - 1)
    pix = y * cam.width + x
    a = alpha.reshape(-1)[pix]
    surf = depth.reshape(-1)[pix] / torch.clamp(a, min=1e-6)
    valid = ((z > 0) & (u >= 0) & (u < cam.width) & (v >= 0)
             & (v < cam.height) & (a > 0.5)).to(torch.float32)
    dist = torch.abs(z - surf)
    beta = torch.clamp(torch.mean(torch.amin(torch.exp(g["log_scales"]),
                                             dim=-1)[nbrs], dim=-1), min=1e-6)
    target = torch.exp(-(dist ** 2) / (2.0 * beta ** 2))
    dens = torch.clamp(density(pts, nbrs, g), 0.0, 1.0)
    loss = loss + s["sdf_weight"] * torch.sum(
        torch.abs(target - dens) * valid) / torch.clamp(valid.sum(), min=1.0)
    grad = density_gradient(pts, nbrs, g)
    n_field = grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True),
                                 min=1e-9)
    cos = torch.sum(n_field * normals(g)[idx], dim=-1)
    return loss + s["normal_weight"] * torch.mean(1.0 - torch.abs(cos))


def loss_and_grads(g: dict, cam: raster.Cam, target, tile: int, t: dict,
                   s: dict, draws, lowp: bool = False):
    """(loss, {field: gradient}) of one regularized step."""
    q = raster.rounder(lowp)
    with ref_train.ieee_float32():
        params = {f: g[f].detach().clone().requires_grad_(True)
                  for f in FIELDS}
        gg = dict(params, active=g["active"])
        with torch.enable_grad():
            sp = raster.preprocess(gg, cam, tile, lowp)
        sd = raster.Splats(*(x.detach() for x in sp))
        with torch.no_grad():
            b = raster.bin_splats(sd, cam.width, cam.height, tile)
            img = raster.blend(sd, b, cam.width, cam.height, tile, lowp)
        color, depth, alpha = (x.detach().requires_grad_(True) for x in img)
        with torch.enable_grad():
            loss = (ref_train.photometric_loss(color, target,
                                               t["lambda_dssim"])
                    + regularizer(gg, cam, depth, alpha, draws, s))
            leaves = [color, depth, alpha, *params.values()]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        g_c, g_d, g_a = grads[:3]
        with torch.no_grad():
            sg = raster.blend_bwd(sd, b, q(g_c), q(g_d), q(g_a), tile, lowp)
        with torch.enable_grad():
            via = torch.autograd.grad(
                [sp.mean2d, sp.conic, sp.color, sp.opacity, sp.depth],
                list(params.values()),
                [sg.mean2d, sg.conic, sg.color, sg.opacity, sg.depth],
                allow_unused=True)
    out = {}
    for f, direct, rendered in zip(FIELDS, grads[3:], via):
        total = torch.zeros_like(params[f])
        for x in (direct, rendered):
            if x is not None:
                total = total + x
        out[f] = q(total)
    return loss.detach(), out


def run(start: dict, cams: list, targets: list, draws: list, tile: int,
        t: dict, s: dict, lowp: bool = False) -> dict:
    """``len(cams)`` regularized steps from ``start`` (not modified), with
    the sample draws of each; the losses, the first gradients and the
    parameters' change."""
    g = {f: start[f].clone() for f in FIELDS}
    g["active"] = start["active"]
    adam = ref_train.Adam(m={f: torch.zeros_like(g[f]) for f in FIELDS},
                          v={f: torch.zeros_like(g[f]) for f in FIELDS})
    losses, first = [], None
    for k, (cam, target, dr) in enumerate(zip(cams, targets, draws)):
        loss, grads = loss_and_grads(g, cam, target, tile, t, s, dr, lowp)
        losses.append(float(loss))
        if first is None:
            first = grads
        ref_train.adam_step(g, adam, grads, k, t)
        del grads
    return {"losses": losses, "grads": first,
            "change": {f: g[f] - start[f] for f in FIELDS}}
