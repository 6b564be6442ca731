"""The LaMa ("big-lama") inpainting network, in PyTorch.

Counterpart of ``autovfx_tpu/perception/lama_jax.py``: the FFC-ResNet
generator of big-lama (``configs/training/big-lama.yaml``: ngf 64,
three stride-2 downsamples, 18 Fast-Fourier-Convolution residual blocks
at global ratio 0.75, three transposed-convolution upsamples, a sigmoid
head) with BatchNorm folded into (scale, shift) pairs, and the
inference contract of ``inpaint_img_with_lama``: the input is
``concat([img * (1 - mask), mask])`` reflect-padded to a multiple of 8,
the output ``mask * pred + (1 - mask) * img``.

Tensors are NCHW and the weights stay in torch's layouts (OIHW, and the
``ConvTranspose2d`` weight (I, O, kh, kw) as the checkpoint holds it).
The spectral unit interleaves the real and imaginary parts channel by
channel (``[c0_re, c0_im, c1_re, ...]``), the order the released
weights were trained with.  The convolutions and FFTs are library calls,
as they are XLA operations in the JAX package; the convolutions run in
IEEE float32 whatever ``torch.backends.cudnn.allow_tf32`` says
(``utils.conv.ieee_float32``), so the card computes what the CPU does.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.utils.conv import ieee_float32

_BN_EPS = 1e-5  # torch BatchNorm2d's default
CKPT_ENV = "AUTOVFX_LAMA_CKPT"


# ---- checkpoint conversion ---------------------------------------------------


def _f32(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _fold_bn(sd: Dict[str, Any], prefix: str, device) -> Tuple[torch.Tensor,
                                                              torch.Tensor]:
    """BatchNorm2d at inference as ``x * scale + shift``, each (C, 1, 1)
    (folded in float32 on the host, as the JAX package folds it)."""
    f = lambda k: np.asarray(_f32(sd[f"{prefix}.{k}"], "cpu").numpy())
    scale = f("weight") / np.sqrt(f("running_var") + _BN_EPS)
    shift = f("bias") - f("running_mean") * scale
    return (_f32(scale, device)[:, None, None],
            _f32(shift, device)[:, None, None])


def _ffc_params(sd: Dict[str, Any], p: str, device) -> Dict[str, Any]:
    """One FFC_BN_ACT: the branch convolutions that exist (a missing key
    is an identity branch of the reference, ratio 0 on one side) and the
    folded BatchNorms."""
    out: Dict[str, Any] = dict.fromkeys(
        ("l2l", "l2g", "g2l", "g2g", "bn_l", "bn_g"))
    for k in ("l2l", "l2g", "g2l"):
        key = f"{p}.ffc.conv{k}.weight"
        if key in sd:
            out[k] = _f32(sd[key], device)
    g2g = f"{p}.ffc.convg2g"
    if g2g + ".conv1.0.weight" in sd:
        out["g2g"] = {
            "conv1": _f32(sd[g2g + ".conv1.0.weight"], device),
            "bn1": _fold_bn(sd, g2g + ".conv1.1", device),
            "fu": _f32(sd[g2g + ".fu.conv_layer.weight"], device),
            "fu_bn": _fold_bn(sd, g2g + ".fu.bn", device),
            "conv2": _f32(sd[g2g + ".conv2.weight"], device),
        }
    for side in ("l", "g"):
        if f"{p}.bn_{side}.weight" in sd:
            out[f"bn_{side}"] = _fold_bn(sd, f"{p}.bn_{side}", device)
    return out


@dataclasses.dataclass
class LamaParams:
    """The generator's converted weights, on one device."""

    init: Dict[str, Any]
    down: List[Dict[str, Any]]
    blocks: List[Dict[str, Any]]  # each {"conv1": ffc, "conv2": ffc}
    up: List[Dict[str, Any]]  # each {"w": (I, O, 3, 3), "b": (O,), "bn"}
    out_w: torch.Tensor
    out_b: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.out_w.device

    def to(self, device) -> "LamaParams":
        """These weights on ``device`` (itself when they are there)."""
        device = torch.device(device)
        if device == self.device:
            return self

        def move(x):
            if torch.is_tensor(x):
                return x.to(device)
            if isinstance(x, dict):
                return {k: move(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(move(v) for v in x)
            return x

        return LamaParams(**{f.name: move(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


def convert_torch_state_dict(sd: Dict[str, Any],
                             device=devices.DEFAULT) -> LamaParams:
    """Parse the ``generator.model.{i}.*`` keys of a LaMa checkpoint by
    structure (any FFCResNetGenerator size): Sequential index 1 is the
    stem, the ``.ffc.`` entries after it the downsamples, the
    ``.conv1.ffc.`` entries the residual blocks, the 4-D (weight, bias)
    pairs after them the transposed convolutions with the BatchNorm that
    follows each, and the last 4-D weight the output convolution."""
    device = devices.resolve(device)
    gsd = {}
    for k, v in sd.items():
        if k.startswith("generator."):
            k = k[len("generator."):]
        if k.startswith("model."):
            gsd[k[len("model."):]] = v
    ndim = lambda k: len(tuple(gsd[k].shape)) if k in gsd else -1
    indices = sorted({int(k.split(".", 1)[0]) for k in gsd})
    out_idx = max(i for i in indices if ndim(f"{i}.weight") == 4)
    init, down, blocks, convt = None, [], [], {}
    for i in indices:
        if f"{i}.ffc.convl2l.weight" in gsd:
            p = _ffc_params(gsd, str(i), device)
            if init is None:
                init = p
            else:
                down.append(p)
        elif f"{i}.conv1.ffc.convl2l.weight" in gsd:
            blocks.append({"conv1": _ffc_params(gsd, f"{i}.conv1", device),
                           "conv2": _ffc_params(gsd, f"{i}.conv2", device)})
        elif ndim(f"{i}.weight") == 4 and i != out_idx:
            convt[i] = {"w": _f32(gsd[f"{i}.weight"], device),
                        "b": _f32(gsd[f"{i}.bias"], device)}
        elif ndim(f"{i}.weight") == 1:
            convt[max(j for j in convt if j < i)]["bn"] = _fold_bn(
                gsd, str(i), device)
    ups = [convt[i] for i in sorted(convt)]
    if init is None or not blocks or not ups:
        raise ValueError(
            "state dict does not look like an FFCResNetGenerator "
            f"(init={init is not None}, blocks={len(blocks)}, ups={len(ups)})")
    return LamaParams(init=init, down=down, blocks=blocks, up=ups,
                      out_w=_f32(gsd[f"{out_idx}.weight"], device),
                      out_b=_f32(gsd[f"{out_idx}.bias"], device))


def resolve_ckpt_file(ckpt_path: str) -> str:
    """The checkpoint file of ``ckpt_path``: the file itself, or in the
    released ``big-lama/`` directory ``models/best.ckpt`` (then
    ``best.ckpt``, ``models/last.ckpt``)."""
    if os.path.isdir(ckpt_path):
        for cand in ("models/best.ckpt", "best.ckpt", "models/last.ckpt"):
            p = os.path.join(ckpt_path, cand)
            if os.path.exists(p):
                return p
    return ckpt_path


def load_lama_params(ckpt_path: str, device=devices.DEFAULT) -> LamaParams:
    """Load and convert a big-lama checkpoint (a ``.ckpt``/``.pt`` file or
    the released directory) onto ``device``.  The file is read as weights
    only; a Lightning checkpoint whose extra entries need the full
    unpickler is read with it."""
    device = devices.resolve(device)
    path = resolve_ckpt_file(ckpt_path)
    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    return convert_torch_state_dict(sd, device=device)


# ---- forward (NCHW, inference only) -------------------------------------------


def _reflect(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          pad: int = 0) -> torch.Tensor:
    if pad:
        x = _reflect(x, pad)
    return F.conv2d(x, w, stride=stride)


def _bn_act(x: torch.Tensor, bn) -> torch.Tensor:
    return torch.relu(x * bn[0] + bn[1])


def _fourier_unit(x: torch.Tensor, w: torch.Tensor, bn) -> torch.Tensor:
    """rfft2 -> a 1x1 convolution over the interleaved (re, im) channels
    -> irfft2 back to the input's (h, w), odd widths included."""
    b, c, h, wd = x.shape
    f = torch.fft.rfft2(x, dim=(-2, -1), norm="ortho")
    f = torch.stack([f.real, f.imag], dim=2).reshape(b, 2 * c, h, wd // 2 + 1)
    f = _bn_act(_conv(f, w), bn)
    f = f.reshape(b, w.shape[0] // 2, 2, h, wd // 2 + 1)
    f = torch.complex(f[:, :, 0], f[:, :, 1])
    return torch.fft.irfft2(f, s=(h, wd), dim=(-2, -1), norm="ortho")


def _spectral(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    x = _bn_act(_conv(x, p["conv1"]), p["bn1"])
    return _conv(x + _fourier_unit(x, p["fu"], p["fu_bn"]), p["conv2"])


def _ffc_bn_act(xl: torch.Tensor, xg: Optional[torch.Tensor],
                p: Dict[str, Any], stride: int = 1, pad: int = 0):
    out_l = out_g = None
    if p["l2l"] is not None:
        out_l = _conv(xl, p["l2l"], stride, pad)
    if p["g2l"] is not None and xg is not None:
        g = _conv(xg, p["g2l"], stride, pad)
        out_l = g if out_l is None else out_l + g
    if p["l2g"] is not None:
        out_g = _conv(xl, p["l2g"], stride, pad)
    if p["g2g"] is not None and xg is not None:
        g = _spectral(xg, p["g2g"])
        out_g = g if out_g is None else out_g + g
    if out_l is not None and p["bn_l"] is not None:
        out_l = _bn_act(out_l, p["bn_l"])
    if out_g is not None and p["bn_g"] is not None:
        out_g = _bn_act(out_g, p["bn_g"])
    return out_l, out_g


def _conv_transpose2x(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """ConvTranspose2d(k3, s2, p1, output_padding=1), BatchNorm, ReLU."""
    y = F.conv_transpose2d(x, p["w"], p["b"], stride=2, padding=1,
                           output_padding=1)
    return _bn_act(y, p["bn"])


def lama_generator(params: LamaParams, x: torch.Tensor) -> torch.Tensor:
    """The FFCResNetGenerator forward: x (B, 4, H, W) float32 with H and W
    multiples of 8 -> (B, 3, H, W) in [0, 1].  Convolutions in IEEE
    float32, no autograd."""
    with torch.no_grad(), ieee_float32():
        xl, _ = _ffc_bn_act(_reflect(x, 3), None, params.init)
        xg = None
        for d in params.down:
            xl, xg = _ffc_bn_act(xl, xg, d, stride=2, pad=1)
        for blk in params.blocks:
            yl, yg = _ffc_bn_act(xl, xg, blk["conv1"], pad=1)
            yl, yg = _ffc_bn_act(yl, yg, blk["conv2"], pad=1)
            xl = xl + yl
            xg = yg if xg is None else xg + yg
        y = xl if xg is None else torch.cat([xl, xg], dim=1)
        for u in params.up:
            y = _conv_transpose2x(y, u)
        y = _conv(_reflect(y, 3), params.out_w) + params.out_b[:, None, None]
        return torch.sigmoid(y)


def inpaint_with_params(params: LamaParams, img: np.ndarray, mask: np.ndarray,
                        mod: int = 8, device=devices.DEFAULT) -> np.ndarray:
    """The inference contract of ``inpaint_img_with_lama`` on ``device``
    (``params`` are moved there if they are elsewhere).

    img: (H, W, 3) uint8 or float in [0, 1]; mask: (H, W), nonzero is
    the hole.  The image is reflect-padded to a multiple of ``mod``.
    Returns (H, W, 3) uint8 (truncated, as the JAX package does)."""
    device = devices.resolve(device)
    params = params.to(device)
    h, w = img.shape[:2]
    imgf = img.astype(np.float32) / (255.0 if img.dtype == np.uint8 else 1.0)
    m = (np.asarray(mask) > 0).astype(np.float32)
    ph, pw = (-h) % mod, (-w) % mod
    imgf = np.pad(imgf, ((0, ph), (0, pw), (0, 0)), mode="reflect")
    m = np.pad(m, ((0, ph), (0, pw)), mode="reflect")
    t_img = torch.from_numpy(np.ascontiguousarray(
        imgf.transpose(2, 0, 1)))[None].to(device)
    t_mask = torch.from_numpy(m)[None, None].to(device)
    pred = lama_generator(params, torch.cat([t_img * (1.0 - t_mask), t_mask],
                                            1))
    out = t_mask * pred + (1.0 - t_mask) * t_img
    out = out[0, :, :h, :w].permute(1, 2, 0).cpu().numpy()
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


def default_ckpt_path() -> Optional[str]:
    """The big-lama checkpoint: ``$AUTOVFX_LAMA_CKPT``, then
    ``~/.cache/autovfx/big-lama``, whichever exists first."""
    for cand in (os.environ.get(CKPT_ENV),
                 os.path.expanduser("~/.cache/autovfx/big-lama")):
        if cand and os.path.exists(cand):
            return cand
    return None


@functools.lru_cache(maxsize=2)
def _cached_params(path: str, device: torch.device) -> LamaParams:
    return load_lama_params(path, device=device)


def try_inpaint(img: np.ndarray, mask: np.ndarray,
                ckpt_path: Optional[str] = None,
                device=devices.DEFAULT) -> Optional[np.ndarray]:
    """LaMa on ``device`` when a checkpoint resolves (converted once per
    path and device); None when none does.  A checkpoint that is there
    but fails to load raises: it never gives way to another inpainter."""
    path = ckpt_path or default_ckpt_path()
    if path is None:
        return None
    device = devices.resolve(device)
    return inpaint_with_params(_cached_params(path, device), img, mask,
                               device=device)
