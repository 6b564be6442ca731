"""The scene-reconstruction CLI of the port.

Counterpart of the repository's ``train_gaussians.py`` (itself
``train_3dgs.sh`` and ``sugar/train.py:113-190``), with the same flags
and defaults plus ``--device`` (``cuda`` unless the CPU is asked for):

  1. vanilla 3DGS training from the COLMAP points (or the ray-mesh /
     hybrid seed points),
  2. coarse SuGaR training with the density regularization,
  3. surface-mesh extraction at the level set,
  4. the mesh-bound Gaussians, their PLY and the baked texture,

then the metrics of the coarse scene.  It writes
``chkpnt<N>.npz`` with ``point_cloud/iteration_<N>/point_cloud.ply``,
``sugarcoarse.ply``, ``mesh.obj``, ``sugarfine.ply``, ``texture.png``
and ``metrics.json`` under ``--model_path``.

Images are read with ``utils/png`` (the machine with the card has no
image library); another format is read with PIL where it can be
imported.  They are resized, when the camera's size differs, with the
image library's bicubic filter (``perception/extract``'s weights).  The
texture holds two faces a square and grows past the reference's 1024²
until the mesh's faces fit, where the reference's ``bake_texture``
fails.

Example:

    python -m autovfx_tpu_torch.train_gaussians --source_path data/garden \\
        --model_path output/garden --downscale 4
"""
import argparse
import os

import numpy as np
import torch

from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.core import ply_io
from autovfx_tpu_torch.dataset.colmap import (
    colmap_to_cameras,
    load_colmap_scene,
)
from autovfx_tpu_torch.edit import mesh_io
from autovfx_tpu_torch.ops.rasterize import RasterConfig
from autovfx_tpu_torch.perception.extract import (
    _resample_matrix,
    _resample_pass,
)
from autovfx_tpu_torch.sugar import coarse_train as CT
from autovfx_tpu_torch.sugar import extract_mesh as EM
from autovfx_tpu_torch.sugar import refine as R
from autovfx_tpu_torch.train import checkpoint as CK
from autovfx_tpu_torch.train import trainer as T
from autovfx_tpu_torch.train.init_points import build_init_points
from autovfx_tpu_torch.utils import metrics as MET
from autovfx_tpu_torch.utils import png


def get_args(argv=None):
    """The reference CLI's flags and ``--device``; ``argv`` defaults to
    the process's arguments."""
    p = argparse.ArgumentParser()
    p.add_argument("--source_path", required=True,
                   help="COLMAP scene dir (sparse/0 + images/)")
    p.add_argument("--model_path", required=True)
    p.add_argument("--iterations", type=int, default=15_000)
    p.add_argument("--coarse_iterations", type=int, default=7_000)
    p.add_argument("--regularize_from", type=int, default=2_000)
    p.add_argument("--downscale", type=float, default=4.0)
    p.add_argument("--capacity", type=int, default=2_000_000)
    p.add_argument("--dup_budget", type=int, default=1 << 22)
    p.add_argument("--surface_level", type=float, default=0.3)
    p.add_argument("--mesh_resolution", type=int, default=192)
    p.add_argument("--target_vertices", type=int, default=1_000_000)
    p.add_argument("--gaussians_per_triangle", type=int, default=1)
    p.add_argument("--init_strategy", default="colmap",
                   choices=["colmap", "ray_mesh", "hybrid"],
                   help="seed-point strategy (dataset_readers.py:176-289);"
                        " ray_mesh/hybrid need --init_mesh")
    p.add_argument("--init_mesh", default=None,
                   help="scene mesh (e.g. BakedSDF export) for ray_mesh/"
                        "hybrid init")
    p.add_argument("--skip_refine", action="store_true")
    p.add_argument("--eval", action="store_true",
                   help="hold out every 8th view for metrics")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the scene trains on (cpu: the "
                        "kernels' plain versions)")
    return p.parse_args(argv)


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an image file: PNG with ``utils/png``, another
    format with PIL, which must then be importable."""
    with open(path, "rb") as f:
        is_png = f.read(8) == b"\x89PNG\r\n\x1a\n"
    if is_png:
        img = png.read_png(path)
        if img.ndim == 2:
            img = img[..., None]
        # grey(+alpha) to RGB, alpha dropped, as PIL's convert("RGB")
        return np.ascontiguousarray(
            np.repeat(img[..., :1], 3, axis=2) if img.shape[2] <= 2
            else img[..., :3])
    try:
        from PIL import Image
    except ImportError as e:
        fmt = os.path.splitext(path)[1] or "unknown"
        raise RuntimeError(
            f"{path}: a {fmt} image needs PIL, which is not installed; "
            "only PNG is read without it") from e
    return np.asarray(Image.open(path).convert("RGB"))


def resize_rgb(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """An (H, W, 3) uint8 image at (height, width) as PIL's default
    bicubic resize makes it: width first, then height, each pass rounded
    and clipped to 8 bits."""
    h0, w0 = img.shape[:2]
    if (h0, w0) == (height, width):
        return img
    x = torch.as_tensor(img, dtype=torch.float64).permute(2, 0, 1)  # (3,H,W)
    if w0 != width:
        x = _resample_pass(x, _resample_matrix(w0, width, "cpu"))
    if h0 != height:
        m = _resample_matrix(h0, height, "cpu")
        x = _resample_pass(x.transpose(1, 2), m).transpose(1, 2)
    return x.permute(1, 2, 0).numpy().astype(np.uint8)


def load_scene(args, device=None):
    """(cameras, (F, H, W, 3) float32 images, SfM xyz, SfM rgb) of
    ``args.source_path`` downscaled by ``args.downscale``, the cameras
    and images on ``device`` (``args.device`` by default)."""
    device = devices.resolve(args.device if device is None else device)
    sparse = os.path.join(args.source_path, "sparse", "0")
    cams, names = colmap_to_cameras(sparse, downscale=args.downscale,
                                    device=device)
    _, _, (xyz, rgb) = load_colmap_scene(sparse)
    img_dir = os.path.join(args.source_path, "images")
    images = [resize_rgb(read_rgb(os.path.join(img_dir, name)), cams.height,
                         cams.width).astype(np.float32) / 255.0
              for name in names]
    return cams, torch.as_tensor(np.stack(images), device=device), xyz, rgb


def main(argv=None):
    """Run the pipeline; returns its states, mesh, bound Gaussians and
    metrics."""
    args = get_args(argv)
    if args.init_strategy != "colmap" and not args.init_mesh:
        raise SystemExit(
            f"--init_strategy {args.init_strategy} requires --init_mesh")
    os.makedirs(args.model_path, exist_ok=True)
    cams, images, xyz, rgb = load_scene(args)
    device = images.device
    print(f"loaded {images.shape[0]} views, {len(xyz)} SfM points")

    raster = RasterConfig(dup_budget=args.dup_budget)
    extent = float(np.abs(cams.center.cpu().numpy()).max()) * 1.1

    # ---- stage 1: vanilla 3DGS ---------------------------------------------
    if args.init_strategy != "colmap":
        mesh = mesh_io.load_mesh(args.init_mesh)
        xyz, rgb = build_init_points(
            args.init_strategy, xyz, rgb, cams=cams,
            images=images.cpu().numpy(), mesh_vertices=mesh.vertices,
            mesh_faces=mesh.faces, device=device)
        print(f"init_strategy={args.init_strategy}: {len(xyz)} seed points")
    g0 = T.init_gaussians_from_points(
        torch.as_tensor(xyz, device=device),
        torch.as_tensor(rgb, device=device)).pad_to(args.capacity)
    cfg = T.TrainConfig(iterations=args.iterations, raster=raster,
                        spatial_lr_scale=extent,
                        densify_until_iter=args.iterations // 2)
    state, hist = T.train(g0, cams, images, cfg, log_every=500)
    for h in hist:
        print(h)
    CK.save_snapshot(args.model_path, state, args.iterations)

    # ---- stage 2: coarse SuGaR ----------------------------------------------
    scfg = CT.SugarConfig(
        base=T.TrainConfig(iterations=args.coarse_iterations, raster=raster,
                           spatial_lr_scale=extent,
                           densify_until_iter=args.regularize_from),
        regularize_from=args.regularize_from)
    state2, hist2 = CT.coarse_train(state.gaussians, cams, images, scfg,
                                    log_every=500)
    for h in hist2:
        print(h)
    coarse_ply = os.path.join(args.model_path, "sugarcoarse.ply")
    ply_io.save_ply(coarse_ply, state2.gaussians)
    print(f"coarse SuGaR -> {coarse_ply}")

    # ---- stage 3: mesh extraction -------------------------------------------
    mesh_path = os.path.join(args.model_path, "mesh.obj")
    mesh = EM.extract_mesh_from_gaussians(
        state2.gaussians, cams, out_path=mesh_path, config=raster,
        level=args.surface_level, fg_resolution=args.mesh_resolution,
        target_vertices=args.target_vertices)
    print(f"mesh: {len(mesh.vertices)} verts, {len(mesh.faces)} faces "
          f"-> {mesh_path}")

    # ---- stage 4: refinement + texture --------------------------------------
    bg = None
    if not args.skip_refine:
        bg = R.bind_to_mesh(mesh, n_per_triangle=args.gaussians_per_triangle,
                            device=device)
        with torch.no_grad():
            refined = R.realize(bg)
        refined_ply = os.path.join(args.model_path, "sugarfine.ply")
        ply_io.save_ply(refined_ply, refined)
        tex, _ = R.bake_texture(bg, R.texture_size_for(len(mesh.faces)))
        png.write_png(os.path.join(args.model_path, "texture.png"),
                      (np.clip(tex, 0, 1) * 255).astype(np.uint8))
        print(f"refined splats -> {refined_ply} (+texture.png, "
              f"{tex.shape[0]}²)")

    # ---- metrics -------------------------------------------------------------
    res = MET.evaluate(state2.gaussians, cams, images, config=raster,
                       out_json=os.path.join(args.model_path, "metrics.json"))
    print("eval:", res["psnr"], "dB PSNR,", res["ssim"], "SSIM")
    return {"state": state, "coarse_state": state2, "mesh": mesh,
            "bound": bg, "metrics": res, "cams": cams, "images": images}


if __name__ == "__main__":
    main()
