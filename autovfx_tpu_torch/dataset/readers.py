"""Multi-format dataset readers.

Counterpart of ``autovfx_tpu/dataset/readers.py`` (itself
``dataset_utils/read_dataset.py``): c2w poses and intrinsics of Tanks &
Temples, Mip-NeRF-360 (COLMAP), LERF, ScanNet++ and nerfstudio captures,
each rotated so that the scene's calibrated up vector maps to +z and,
for 360, zero-centered and scaled to the camera-diagonal unit sphere
(read_dataset.py:157-201).  Host numpy, as there.

Every reader returns a ``DatasetCameras`` bundle:
  names:  image file names (sorted deterministically)
  c2w:    (N, 3, 4) OpenCV-convention camera-to-world
  K:      (3, 3) shared pinhole intrinsics
  img_wh: (2,) int, or None where the format does not record it

``to_cameras`` turns one into this package's stacked ``Camera`` on a
device.
"""
from __future__ import annotations

import glob
import json
import os
from typing import NamedTuple, Optional

import numpy as np

from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core import device as devices
from autovfx_tpu_torch.dataset.alignment import up_alignment_rotation
from autovfx_tpu_torch.dataset.colmap import (
    qvec_to_rotmat,
    read_cameras_bin,
    read_images_bin,
)

# per-scene up vectors the reference calibrated once and checked in
# (read_dataset.py:31-61) — scene data, reproduced verbatim
SCENE_UP_VECTORS = {
    "tnt": {
        "Playground": [-0.00720354, -0.9963133, -0.08548705],
    },
    "360": {
        "bonsai": [0.02405242, -0.77633506, -0.6298614],
        "counter": [0.07449666, -0.80750495, -0.5851376],
        "garden": [-0.03292375, -0.8741887, -0.48446894],
    },
    "lerf": {
        "donuts": [0.0, 0.0, 1.0],
        "dozer_nerfgun_waldo": [-0.76060444, 0.00627117, 0.6491853],
        "espresso": [0.0, 0.0, 1.0],
        "figurines": [0.0, 0.0, 1.0],
        "ramen": [0.0, 0.0, 1.0],
        "shoe_rack": [0.0, 0.0, 1.0],
        "teatime": [0.0, 0.0, 1.0],
        "waldo_kitchen": [0.0, 0.0, 1.0],
    },
}

_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])


class DatasetCameras(NamedTuple):
    names: list
    c2w: np.ndarray  # (N, 3, 4) OpenCV convention
    K: np.ndarray  # (3, 3)
    img_wh: Optional[np.ndarray]  # (2,) or None


def _scene_up(kind: str, dataset_dir: str) -> Optional[np.ndarray]:
    scene = os.path.basename(os.path.normpath(dataset_dir))
    v = SCENE_UP_VECTORS.get(kind, {}).get(scene)
    return None if v is None else np.asarray(v, np.float64)


def _align_c2w(c2w: np.ndarray, up: Optional[np.ndarray]) -> np.ndarray:
    """Rotate every c2w so the scene up vector maps to +z."""
    if up is None:
        return c2w
    r = up_alignment_rotation(up)
    out = c2w.copy()
    out[:, :3, :3] = np.einsum("ij,njk->nik", r, c2w[:, :3, :3])
    out[:, :3, 3] = c2w[:, :3, 3] @ r.T
    return out


def _normalize_centers(c2w: np.ndarray) -> np.ndarray:
    """Zero-center camera positions and scale by 1.1x the max camera
    distance (read_dataset.py:178-195)."""
    centers = c2w[:, :3, 3]
    mean = centers.mean(axis=0)
    radius = 1.1 * max(
        float(np.linalg.norm(centers - mean, axis=1).max()), 1e-9
    )
    out = c2w.copy()
    out[:, :3, 3] = (centers - mean) / radius
    return out


def read_tnt(dataset_dir: str) -> DatasetCameras:
    """Tanks & Temples: pose/*.txt c2w files + intrinsics.txt."""
    pose_files = sorted(glob.glob(os.path.join(dataset_dir, "pose", "*.txt")))
    if not pose_files:
        raise FileNotFoundError(f"no pose/*.txt under {dataset_dir}")
    names, mats = [], []
    for pf in pose_files:
        m = np.loadtxt(pf).reshape(-1, 4)[:3]
        names.append(os.path.splitext(os.path.basename(pf))[0] + ".png")
        mats.append(m)
    c2w = np.stack(mats).astype(np.float64)
    c2w = _align_c2w(c2w, _scene_up("tnt", dataset_dir))
    K = np.loadtxt(os.path.join(dataset_dir, "intrinsics.txt"))[:3, :3]
    return DatasetCameras(names, c2w, K, None)


def _colmap_K(cam) -> np.ndarray:
    if cam.model == "SIMPLE_RADIAL" or cam.model == "SIMPLE_PINHOLE":
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    elif cam.model in ("PINHOLE", "OPENCV"):
        fx, fy, cx, cy = cam.params[:4]
    else:
        raise ValueError(f"unsupported COLMAP camera model {cam.model}")
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def read_360(dataset_dir: str) -> DatasetCameras:
    """Mip-NeRF-360 COLMAP captures: sparse/0 w2c -> aligned,
    zero-centered, diagonal-normalized c2w."""
    sparse = os.path.join(dataset_dir, "sparse", "0")
    imdata = read_images_bin(os.path.join(sparse, "images.bin"))
    names, mats = [], []
    for k in sorted(imdata, key=lambda k: imdata[k].name):
        im = imdata[k]
        r = qvec_to_rotmat(np.asarray(im.qvec))
        t = np.asarray(im.tvec).reshape(3)
        # w2c -> c2w
        c2w = np.concatenate([r.T, (-r.T @ t)[:, None]], axis=1)
        names.append(im.name)
        mats.append(c2w)
    c2w = np.stack(mats).astype(np.float64)
    c2w = _align_c2w(c2w, _scene_up("360", dataset_dir))
    c2w = _normalize_centers(c2w)
    cams = read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    K = _colmap_K(cams[min(cams)])
    return DatasetCameras(names, c2w, K, None)


def _read_transforms_json(
    dataset_dir: str, meta_name: str = "transforms.json"
):
    with open(os.path.join(dataset_dir, meta_name)) as f:
        meta = json.load(f)
    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])
    names, mats = [], []
    for fr in frames:
        m = np.asarray(fr["transform_matrix"], np.float64) @ _GL_TO_CV
        names.append(os.path.basename(fr["file_path"]))
        mats.append(m[:3])
    if "fl_x" in meta:
        src = meta
    else:
        src = frames[0]
    K = np.array(
        [
            [src["fl_x"], 0, src["cx"]],
            [0, src["fl_y"], src["cy"]],
            [0, 0, 1],
        ],
        np.float64,
    )
    wh = (
        np.array([int(meta["w"]), int(meta["h"])])
        if "w" in meta
        else None
    )
    return names, np.stack(mats), K, wh


def read_lerf(dataset_dir: str) -> DatasetCameras:
    """LERF: transforms.json (OpenGL c2w) + per-scene up alignment."""
    names, c2w, K, wh = _read_transforms_json(dataset_dir)
    c2w = _align_c2w(c2w, _scene_up("lerf", dataset_dir))
    return DatasetCameras(names, c2w, K, wh)


def read_nerfstudio(dataset_dir: str) -> DatasetCameras:
    """nerfstudio capture: transforms.json, no alignment."""
    names, c2w, K, wh = _read_transforms_json(dataset_dir)
    return DatasetCameras(names, c2w, K, wh)


def read_scannetpp(dataset_dir: str) -> DatasetCameras:
    """ScanNet++ DSLR: COLMAP text extrinsics + undistorted-nerfstudio
    intrinsics (read_dataset.py:304-341)."""
    images_txt = os.path.join(dataset_dir, "dslr", "colmap", "images.txt")
    names, mats = [], []
    with open(images_txt) as f:
        lines = [
            ln.strip()
            for ln in f
            if ln.strip() and not ln.startswith("#")
        ]
    # COLMAP images.txt: two lines per image; first holds the pose
    for ln in lines[::2]:
        parts = ln.split()
        q = np.array([float(x) for x in parts[1:5]])
        t = np.array([float(x) for x in parts[5:8]])
        r = qvec_to_rotmat(q)
        c2w = np.concatenate([r.T, (-r.T @ t)[:, None]], axis=1)
        names.append(parts[9])
        mats.append(c2w)
    order = np.argsort(names)
    names = [names[i] for i in order]
    c2w = np.stack([mats[i] for i in order]).astype(np.float64)
    with open(
        os.path.join(
            dataset_dir, "dslr", "nerfstudio", "transforms_undistorted.json"
        )
    ) as f:
        meta = json.load(f)
    K = np.array(
        [
            [meta["fl_x"], 0, meta["cx"]],
            [0, meta["fl_y"], meta["cy"]],
            [0, 0, 1],
        ],
        np.float64,
    )
    wh = np.array([int(meta["w"]), int(meta["h"])])
    return DatasetCameras(names, c2w, K, wh)


_READERS = {
    "tnt": read_tnt,
    "360": read_360,
    "lerf": read_lerf,
    "nerfstudio": read_nerfstudio,
    "scannetpp": read_scannetpp,
}


def read_dataset(dataset_dir: str, kind: str) -> DatasetCameras:
    """Unified entry: kind in {tnt, 360, lerf, nerfstudio, scannetpp}."""
    if kind not in _READERS:
        raise ValueError(
            f"unknown dataset kind '{kind}' (choose from {sorted(_READERS)})"
        )
    return _READERS[kind](dataset_dir)


def to_cameras(dc: DatasetCameras, width: Optional[int] = None,
               height: Optional[int] = None,
               device=devices.DEFAULT) -> C.Camera:
    """The stacked ``Camera`` of a ``DatasetCameras`` on ``device``
    (``camera_from_c2w`` of each pose).  The image size is ``img_wh``,
    or ``width``/``height`` where the format records none."""
    device = devices.resolve(device)
    if dc.img_wh is not None:
        width, height = int(dc.img_wh[0]), int(dc.img_wh[1])
    if width is None or height is None:
        raise ValueError("the dataset records no image size: pass width "
                         "and height")
    K = np.asarray(dc.K, np.float64)
    bottom = np.array([0.0, 0.0, 0.0, 1.0])
    return C.stack_cameras([
        C.camera_from_c2w(np.concatenate([m, bottom[None]]), K[0, 0],
                          K[1, 1], K[0, 2], K[1, 2], width, height,
                          device=device)
        for m in np.asarray(dc.c2w, np.float64)])
