"""COLMAP dataset ingestion.

Counterpart of ``autovfx_tpu/dataset/colmap.py`` (itself
``dataset_utils/colmap_read_model.py`` and ``colmap_runner.py``): the
binary readers of ``cameras.bin``, ``images.bin`` and ``points3D.bin``
(numpy, as there), ``load_colmap_scene``, ``colmap_to_cameras``, which
builds this package's ``Camera`` batch on a chosen device, and
``run_colmap_sfm``, which needs the ``colmap`` binary on PATH.
"""
from __future__ import annotations

import os
import shutil
import struct
import subprocess
from typing import Dict, NamedTuple, Tuple

import numpy as np

from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core import device as devices


class ColmapCamera(NamedTuple):
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    name: str
    qvec: np.ndarray  # wxyz, world -> camera
    tvec: np.ndarray
    camera_id: int


_CAM_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
}


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = _CAM_MODELS.get(model_id, (f"MODEL{model_id}", 4))
            params = np.array(struct.unpack(f"<{np_}d", f.read(8 * np_)))
            out[cam_id] = ColmapCamera(name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            img_id = struct.unpack("<i", f.read(4))[0]
            q = np.array(struct.unpack("<4d", f.read(32)))
            t = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n2d)  # the 2D points
            out[img_id] = ColmapImage(name.decode(), q, t, cam_id)
    return out


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz (N, 3) float32, rgb (N, 3) float32 in 0..1); the records are
    parsed from one read of the file."""
    with open(path, "rb") as f:
        buf = f.read()
    n = struct.unpack_from("<Q", buf, 0)[0]
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    rec = struct.Struct("<Q3d3BdQ")  # id, xyz, rgb, error, track length
    off = 8
    for i in range(n):
        fields = rec.unpack_from(buf, off)
        xyz[i] = fields[1:4]
        rgb[i] = fields[4:7]
        off += rec.size + 8 * fields[8]  # the track's (image, point2D) ids
    return xyz.astype(np.float32), rgb.astype(np.float32) / 255.0


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def load_colmap_scene(sparse_dir: str):
    """(cameras dict, images dict, (xyz, rgb)) of a COLMAP sparse model
    (the 3DGS ``<scene>/sparse/0`` layout)."""
    cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    pts_path = os.path.join(sparse_dir, "points3D.bin")
    pts = read_points3d_bin(pts_path) if os.path.exists(pts_path) else (
        np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
    return cams, imgs, pts


def colmap_to_cameras(sparse_dir: str, downscale: float = 1.0,
                      device=devices.DEFAULT):
    """(stacked ``Camera`` on ``device``, image names) of a COLMAP model,
    sorted by image name as ``loadCustomCameras`` does."""
    device = devices.resolve(device)
    cams, imgs, _ = load_colmap_scene(sparse_dir)
    views, names = [], []
    for img in sorted(imgs.values(), key=lambda i: i.name):
        cam = cams[img.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
            cx, cy = cam.params[1], cam.params[2]
        else:  # PINHOLE-like: fx fy cx cy first
            fx, fy, cx, cy = cam.params[:4]
        w2c = np.eye(4)
        w2c[:3, :3] = qvec_to_rotmat(img.qvec)
        w2c[:3, 3] = img.tvec
        views.append(C.camera_from_c2w(
            np.linalg.inv(w2c), fx / downscale, fy / downscale,
            cx / downscale, cy / downscale, round(cam.width / downscale),
            round(cam.height / downscale), device=device))
        names.append(img.name)
    return C.stack_cameras(views), names


def run_colmap_sfm(image_dir: str, out_dir: str) -> str:
    """COLMAP SfM from scratch (colmap_runner.py:87-121); needs the
    ``colmap`` binary on PATH.  Returns the sparse model's directory."""
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "COLMAP binary not found on PATH: install COLMAP or provide a "
            "precomputed sparse/ model (read with load_colmap_scene).")
    os.makedirs(out_dir, exist_ok=True)
    db = os.path.join(out_dir, "database.db")
    sparse = os.path.join(out_dir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    subprocess.run(["colmap", "feature_extractor", "--database_path", db,
                    "--image_path", image_dir], check=True)
    subprocess.run(["colmap", "exhaustive_matcher", "--database_path", db],
                   check=True)
    subprocess.run(["colmap", "mapper", "--database_path", db, "--image_path",
                    image_dir, "--output_path", sparse], check=True)
    return os.path.join(sparse, "0")
