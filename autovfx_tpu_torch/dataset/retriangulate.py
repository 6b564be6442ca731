"""Known-pose re-triangulation (COLMAP's second stage).

Counterpart of ``autovfx_tpu/dataset/retriangulate.py`` (itself
``dataset_utils/colmap_runner.py:124-168``, ``runner_with_known_poses``:
feature extraction, the known intrinsics written into the database,
exhaustive matching and point triangulation with FIXED poses, and the
``database.py`` injection of ``modify_db``).  Host code, as there, on
this package's cameras:

  - the ``colmap`` binary when it is installed (the same four steps);
  - otherwise ORB features, cross-checked matching and
    ``cv2.triangulatePoints`` under the known projection matrices with
    reprojection-error and cheirality filters (OpenCV is imported only
    on this route).

Images are read with ``utils/png`` (PIL only for other formats).
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np

from autovfx_tpu_torch.core.cameras import Camera, index_camera, num_cameras


def _k_matrix(cam) -> np.ndarray:
    return np.array(
        [
            [float(cam.fx), 0, float(cam.cx)],
            [0, float(cam.fy), float(cam.cy)],
            [0, 0, 1],
        ]
    )


def write_cameras_txt(cams: Camera, path: str) -> None:
    """COLMAP cameras.txt, one PINHOLE entry per camera."""
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL W H PARAMS[]\n")
        for i in range(num_cameras(cams)):
            c = index_camera(cams, i)
            f.write(
                f"{i + 1} PINHOLE {c.width} {c.height} "
                f"{float(c.fx)} {float(c.fy)} "
                f"{float(c.cx)} {float(c.cy)}\n"
            )


def write_images_txt(cams: Camera, names: List[str], path: str) -> None:
    """COLMAP images.txt with w2c quaternion/translation per image."""
    from autovfx_tpu_torch.core.quaternion import rotmat_to_quat

    with open(path, "w") as f:
        f.write(
            "# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n"
        )
        for i, name in enumerate(names):
            c = index_camera(cams, i)
            q = rotmat_to_quat(c.R).cpu().numpy()  # wxyz
            t = c.t.cpu().numpy()
            f.write(
                f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} "
                f"{t[0]} {t[1]} {t[2]} {i + 1} {name}\n\n"
            )


def modify_database(db_path: str, cams: Camera, names: List[str]) -> None:
    """Inject known intrinsics into a COLMAP database
    (colmap_runner.py modify_db / database.py analog, via sqlite3)."""
    import sqlite3

    conn = sqlite3.connect(db_path)
    cur = conn.cursor()
    name_to_idx = {n: i for i, n in enumerate(names)}
    for image_id, name in cur.execute(
        "SELECT image_id, name FROM images"
    ).fetchall():
        i = name_to_idx.get(os.path.basename(name))
        if i is None:
            continue
        c = index_camera(cams, i)
        params = np.array(
            [float(c.fx), float(c.fy), float(c.cx), float(c.cy)],
            np.float64,
        )
        cur.execute(
            "UPDATE cameras SET model=1, width=?, height=?, params=?, "
            "prior_focal_length=1 WHERE camera_id="
            "(SELECT camera_id FROM images WHERE image_id=?)",
            (c.width, c.height, params.tobytes(), image_id),
        )
    conn.commit()
    conn.close()


def _colmap_pipeline(image_dir: str, cams, names, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    db = os.path.join(out_dir, "database.db")
    sparse = os.path.join(out_dir, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    subprocess.run(
        ["colmap", "feature_extractor", "--database_path", db,
         "--image_path", image_dir,
         "--ImageReader.camera_model", "PINHOLE"],
        check=True,
    )
    modify_database(db, cams, names)
    subprocess.run(
        ["colmap", "exhaustive_matcher", "--database_path", db,
         "--SiftMatching.guided_matching", "1"],
        check=True,
    )
    write_cameras_txt(cams, os.path.join(sparse, "cameras.txt"))
    write_images_txt(cams, names, os.path.join(sparse, "images.txt"))
    open(os.path.join(sparse, "points3D.txt"), "w").close()
    subprocess.run(
        ["colmap", "point_triangulator", "--database_path", db,
         "--image_path", image_dir, "--input_path", sparse,
         "--output_path", sparse],
        check=True,
    )
    return sparse


def _native_triangulate(
    images: List[np.ndarray],
    cams: Camera,
    n_features: int = 4000,
    max_pairs_per_image: int = 4,
    reproj_thresh: float = 2.0,
):
    """ORB + known-pose two-view triangulation (points, colors)."""
    import cv2

    n = len(images)
    # permissive corner thresholds: splat renders are soft-textured
    orb = cv2.ORB_create(
        nfeatures=n_features, fastThreshold=5, edgeThreshold=8
    )
    kps, descs = [], []
    for img in images:
        g8 = (
            img
            if img.dtype == np.uint8
            else np.clip(img * 255, 0, 255).astype(np.uint8)
        )
        gray = cv2.cvtColor(g8, cv2.COLOR_RGB2GRAY)
        kp, de = orb.detectAndCompute(gray, None)
        kps.append(kp)
        descs.append(de)

    projs = []
    for i in range(n):
        c = index_camera(cams, i)
        K = _k_matrix(c)
        Rt = np.concatenate(
            [c.R.cpu().numpy(), c.t.cpu().numpy()[:, None]], axis=1
        )
        projs.append(K @ Rt)

    bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
    pts_all, col_all = [], []
    for i in range(n):
        if descs[i] is None:
            continue
        for j in range(i + 1, min(i + 1 + max_pairs_per_image, n)):
            if descs[j] is None:
                continue
            matches = bf.match(descs[i], descs[j])
            if not matches:
                continue
            pi = np.array(
                [kps[i][m.queryIdx].pt for m in matches], np.float64
            ).T  # (2, M)
            pj = np.array(
                [kps[j][m.trainIdx].pt for m in matches], np.float64
            ).T
            X_h = cv2.triangulatePoints(projs[i], projs[j], pi, pj)
            X = (X_h[:3] / np.where(np.abs(X_h[3]) > 1e-12, X_h[3], 1e-12)).T

            def reproj(P, X, px):
                x = (P[:, :3] @ X.T + P[:, 3:4]).T
                z = x[:, 2]
                uv = x[:, :2] / np.where(
                    np.abs(z[:, None]) > 1e-9, z[:, None], 1e-9
                )
                return uv, z

            uv_i, z_i = reproj(projs[i], X, pi)
            uv_j, z_j = reproj(projs[j], X, pj)
            err = np.maximum(
                np.linalg.norm(uv_i - pi.T, axis=1),
                np.linalg.norm(uv_j - pj.T, axis=1),
            )
            ok = (z_i > 1e-3) & (z_j > 1e-3) & (err < reproj_thresh)
            if not ok.any():
                continue
            pts_all.append(X[ok])
            ui = np.clip(
                pi.T[ok].astype(int), 0,
                [images[i].shape[1] - 1, images[i].shape[0] - 1],
            )
            img8 = (
                images[i]
                if images[i].dtype == np.uint8
                else np.clip(images[i] * 255, 0, 255).astype(np.uint8)
            )
            col_all.append(img8[ui[:, 1], ui[:, 0]] / 255.0)
    if not pts_all:
        return np.zeros((0, 3)), np.zeros((0, 3))
    return np.concatenate(pts_all), np.concatenate(col_all)


def triangulate_known_poses(
    image_dir: str,
    cams: Camera,
    names: List[str],
    out_dir: str,
    use_colmap: Optional[bool] = None,
):
    """Re-triangulate a scene under FIXED poses; writes
    ``points3d.npz`` (points, colors) and returns (points, colors)."""
    os.makedirs(out_dir, exist_ok=True)
    if use_colmap is None:
        use_colmap = shutil.which("colmap") is not None
    if use_colmap:
        sparse = _colmap_pipeline(image_dir, cams, names, out_dir)
        from autovfx_tpu_torch.dataset.colmap import read_points3d_bin

        pts, cols = read_points3d_bin(
            os.path.join(sparse, "points3D.bin")
        )
    else:
        from autovfx_tpu_torch.utils.png import read_rgb

        images = [read_rgb(os.path.join(image_dir, n)) for n in names]
        pts, cols = _native_triangulate(images, cams)
    np.savez(
        os.path.join(out_dir, "points3d.npz"), points=pts, colors=cols
    )
    return pts, cols
