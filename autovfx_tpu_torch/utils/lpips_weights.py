"""Write the LPIPS(vgg) weights ``.npz`` that ``utils/lpips`` reads from
``AUTOVFX_LPIPS_WEIGHTS``.

Counterpart of the JAX package's ``scripts/convert_lpips_weights.py``.
From checkpoints already on disk:

    python -m autovfx_tpu_torch.utils.lpips_weights \\
        --vgg16 ~/.cache/torch/hub/checkpoints/vgg16-397923af.pth \\
        --lpips .../lpips/weights/v0.1/vgg.pth --out lpips_vgg.npz

or, where the ``lpips`` package is importable and torchvision's VGG16
weights are already in torch hub's cache (nothing is fetched):

    python -m autovfx_tpu_torch.utils.lpips_weights --from-package \\
        --out lpips_vgg.npz

The file is then loaded back on ``--device`` (default the card), as
``lpips_distance`` will load it.  With ``AUTOVFX_LPIPS_WEIGHTS=lpips_vgg.npz`` the reported
LPIPS is canonical LPIPS(vgg), comparable to the reference's
``sugar/metrics.py`` numbers.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.utils.lpips import _file_params, convert_torch_lpips

VGG16_FILE = "vgg16-397923af.pth"  # torchvision's ImageNet weights


def _to_np(state) -> dict:
    return {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
            for k, v in state.items()}


def get_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vgg16", help="torchvision vgg16 .pth state dict")
    ap.add_argument("--lpips", help="lpips package vgg.pth (linear heads)")
    ap.add_argument("--from-package", action="store_true",
                    help="take both from the installed lpips package")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=devices.DEFAULT,
                    help="device the written weights are loaded on to be "
                         "checked")
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> str:
    args = get_args(argv)
    device = devices.resolve(args.device)
    if args.from_package:
        import lpips as lpips_pkg

        # the heads ship inside the package; pnet_rand keeps it from
        # loading (or fetching) the backbone, which is read from
        # torchvision's cache instead
        lpips_state = _to_np(lpips_pkg.LPIPS(net="vgg",
                                             pnet_rand=True).state_dict())
        cached = os.path.join(torch.hub.get_dir(), "checkpoints",
                              VGG16_FILE)
        if not os.path.exists(cached):
            raise SystemExit(f"{cached} is not there: pass --vgg16")
        vgg_state = _to_np(torch.load(cached, map_location="cpu"))
    else:
        if not (args.vgg16 and args.lpips):
            raise SystemExit("--vgg16 and --lpips are required without "
                             "--from-package")
        vgg_state = _to_np(torch.load(args.vgg16, map_location="cpu"))
        lpips_state = _to_np(torch.load(args.lpips, map_location="cpu"))
    out = convert_torch_lpips(vgg_state, lpips_state)
    path = args.out if args.out.endswith(".npz") else args.out + ".npz"
    np.savez(path, **out)
    params = _file_params(path, device)
    print(f"wrote {path}: {len(out)} arrays; loaded on {device} as "
          f"{len(params.convs)} convolutions and {len(params.lins)} heads")
    return path


if __name__ == "__main__":
    main()
