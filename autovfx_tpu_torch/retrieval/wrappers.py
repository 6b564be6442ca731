"""Asset and material retrieval (Objaverse, Meshy, PolyHaven, the ChatSim
bank).

Counterpart of ``autovfx_tpu/retrieval/wrappers.py`` (the reference's
``retrieval/wrapper_objaverse.py``: SBERT + SCaNN text search, CLIP
re-rank, glb download, the animated database, Meshy text-to-3D; and
``retrieval/wrapper_polyhaven.py``: SBERT name similarity over material
folders), with the same ranking and the same draws from Python's
``random``, so a run seeded alike picks the same asset.

Without network access retrieval works over a local library: point
``AUTOVFX_ASSET_DIR`` at a folder of ``<name>.glb|gltf|obj|ply`` files
and ``AUTOVFX_MATERIAL_DIR`` at PolyHaven-style material folders.  With
network access and API keys the Objaverse and Meshy paths take over.
The CLIP re-rank reads its previews with ``utils.png`` (the machine with
the card has no image library).
"""
from __future__ import annotations

import glob
import os
import random
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np

ASSET_DIR_ENV = "AUTOVFX_ASSET_DIR"
MATERIAL_DIR_ENV = "AUTOVFX_MATERIAL_DIR"


class AssetNotFound(RuntimeError):
    pass


class _hub_offline_first:
    """Force HF-hub loads to resolve from the local cache only, unless
    the deployment opts into downloads (AUTOVFX_ALLOW_HUB_DOWNLOAD=1).
    Without this, a zero-egress host spends ~25 s/file in hub retry
    backoff before our fallback path gets control."""

    KEYS = ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE")

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        if os.environ.get("AUTOVFX_ALLOW_HUB_DOWNLOAD") != "1":
            for k in self.KEYS:
                os.environ[k] = "1"
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


@lru_cache(maxsize=1)
def _sbert():
    try:
        with _hub_offline_first():
            from sentence_transformers import SentenceTransformer

            return SentenceTransformer("all-MiniLM-L6-v2")
    except Exception:
        return None


def _similarity_rank(query: str, names: List[str]) -> np.ndarray:
    """Cosine similarities query↔names via SBERT; token-overlap fallback."""
    model = _sbert()
    if model is not None:
        try:
            em = model.encode([query] + names, normalize_embeddings=True)
            return em[0] @ em[1:].T
        except Exception:
            pass
    q = set(query.lower().split())
    sims = []
    for n in names:
        t = set(n.lower().replace("_", " ").replace("-", " ").split())
        sims.append(len(q & t) / max(len(q | t), 1))
    return np.asarray(sims)


def _local_assets() -> List[str]:
    root = os.environ.get(ASSET_DIR_ENV, "")
    if not root or not os.path.isdir(root):
        return []
    out = []
    for ext in ("glb", "gltf", "obj", "ply"):
        out += glob.glob(os.path.join(root, f"**/*.{ext}"), recursive=True)
    return sorted(out)


@lru_cache(maxsize=1)
def _clip():
    """CLIP (ViT-L by default) from a local transformers cache; None
    when unavailable.  Point ``AUTOVFX_CLIP_MODEL`` at a local model
    dir or a cached hub name."""
    name = os.environ.get(
        "AUTOVFX_CLIP_MODEL", "openai/clip-vit-large-patch14"
    )
    try:
        from transformers import CLIPModel, CLIPProcessor

        model = CLIPModel.from_pretrained(name, local_files_only=True)
        proc = CLIPProcessor.from_pretrained(name, local_files_only=True)
        return model, proc
    except Exception:
        return None


def clip_rerank(
    query: str, paths: List[str], sims: np.ndarray,
    preview_dir: Optional[str] = None,
) -> np.ndarray:
    """CLIP image-text re-rank of retrieval candidates
    (wrapper_objaverse.py:183-201): each candidate gets 4 turntable
    preview renders on the card (render/preview.py — the GObjaverse
    pre-rendered views analog); total score = SBERT cosine + mean CLIP
    image-text cosine.  Without a local CLIP cache the SBERT scores pass through
    unchanged."""
    pack = _clip()
    if pack is None:
        return np.asarray(sims)
    model, proc = pack
    import torch

    from autovfx_tpu_torch.render.preview import render_asset_previews
    from autovfx_tpu_torch.utils import png

    preview_dir = preview_dir or os.path.join(
        os.environ.get("AUTOVFX_CACHE_DIR", "_cache"), "asset_previews"
    )
    with torch.no_grad():
        t_in = proc(text=[query], return_tensors="pt", padding=True)
        t_feat = model.get_text_features(**t_in)
        t_feat = t_feat / t_feat.norm(dim=-1, keepdim=True)
        scores = np.array(sims, np.float32).copy()
        for i, p in enumerate(paths):
            oid = os.path.splitext(os.path.basename(p))[0]
            try:
                folder = render_asset_previews(p, preview_dir, oid)
                imgs = [
                    png.read_png(os.path.join(folder, f))[..., :3]
                    for f in sorted(os.listdir(folder))
                    if f.endswith(".png")
                ]
                if not imgs:
                    continue
                i_in = proc(images=imgs, return_tensors="pt")
                i_feat = model.get_image_features(**i_in)
                i_feat = i_feat / i_feat.norm(dim=-1, keepdim=True)
                scores[i] = scores[i] + float(
                    (t_feat @ i_feat.T).mean()
                )
            except Exception as e:  # noqa: BLE001 — skip bad assets
                print(f"# clip_rerank: skipping {p} ({e})")
    return scores


def glb_has_animation(path: str) -> bool:
    """True when a .glb/.gltf carries animation channels (the
    reference's animated-asset db membership check,
    wrapper_objaverse.py:29-36).  Non-glTF formats: False."""
    import json as _json
    import struct

    low = path.lower()
    try:
        if low.endswith(".gltf"):
            with open(path) as f:
                return bool(_json.load(f).get("animations"))
        if low.endswith(".glb"):
            with open(path, "rb") as f:
                magic, _ver, _length = struct.unpack("<III", f.read(12))
                if magic != 0x46546C67:  # 'glTF'
                    return False
                chunk_len, chunk_type = struct.unpack("<II", f.read(8))
                if chunk_type != 0x4E4F534A:  # 'JSON'
                    return False
                return bool(
                    _json.loads(f.read(chunk_len)).get("animations")
                )
    except Exception:
        return False
    return False


def _retrieve_via_index(object_name: str, is_animated: bool) -> Optional[Dict]:
    """Precomputed-embedding-DB path (wrapper_objaverse.py:141-223):
    index search (top-10, cosine ≥ 0.6, animated mask = the separate
    animated db) → resolve glbs via the download client → CLIP re-rank
    → DOWNLOAD_TOP_K=5 random pick.  Returns None when no index is
    configured or nothing resolves, so the local-library path takes
    over."""
    from autovfx_tpu_torch.retrieval import objaverse_index as OI

    idx_path = OI.default_index_path()
    if not idx_path:
        return None
    try:
        index = OI.ObjaverseIndex.load(idx_path)
        uids, dists = index.search(
            object_name, top_k=10, cosine_threshold=0.6,
            animated_only=is_animated,
        )
    except Exception as e:  # noqa: BLE001 — bad index → local fallback
        print(f"# objaverse index unusable ({e}); using local library")
        return None
    if not uids:
        return None
    cache = os.environ.get("AUTOVFX_CACHE_DIR", "_cache")
    paths = OI.download_objects(uids, os.path.join(cache, "assets"))
    resolved = [(u, d) for u, d in zip(uids, dists) if u in paths]
    if not resolved:
        return None
    # GObjaverse pre-rendered views feed the CLIP re-rank when the index
    # carries path fragments (ref :175-201); otherwise clip_rerank
    # renders local turntable previews itself.
    OI.download_gobjaverse_previews(
        index.gobj_paths([u for u, _ in resolved]),
        os.path.join(cache, "assets_rendering_gobjaverse"),
    )
    scores = clip_rerank(
        object_name,
        [paths[u] for u, _ in resolved],
        np.asarray([d for _, d in resolved]),
    )
    order = np.argsort(-scores)[:5]
    uid = resolved[int(random.choice(list(order)))][0]
    return {
        "object_name": object_name,
        "object_id": uid,
        "object_path": paths[uid],
    }


def retrieve_asset_from_objaverse(
    object_name: str, is_animated: bool = False
) -> Dict:
    """SBERT top-10 → CLIP image-text re-rank → top-5 random pick
    (wrapper_objaverse.py:141-223).

    Resolution order: (1) a precomputed embedding index
    (``$AUTOVFX_OBJAVERSE_INDEX`` / ``_cache/objaverse_index.npz`` —
    the reference's SBERT-db+SCaNN path, built by ``python -m
    autovfx_tpu_torch.retrieval.build_index``), (2) the local asset
    library.
    ``is_animated=True`` restricts candidates to the index's animated
    mask, or to glTF assets carrying animation channels locally (the
    animated-embedding-db analog).
    """
    via_index = _retrieve_via_index(object_name, is_animated)
    if via_index is not None:
        return via_index
    assets = _local_assets()
    if is_animated:
        assets = [p for p in assets if glb_has_animation(p)]
    if assets:
        names = [
            os.path.splitext(os.path.basename(p))[0].replace("_", " ")
            for p in assets
        ]
        sims = _similarity_rank(object_name, names)
        order = np.argsort(-sims)
        cand = [i for i in order[:10] if sims[i] >= 0.3]
        if not cand:
            cand = list(order[:1])
        # CLIP re-rank over the SBERT shortlist (ref :183-201); score =
        # sbert + clip, then DOWNLOAD_TOP_K=5 random pick
        scores = clip_rerank(
            object_name, [assets[i] for i in cand],
            np.asarray([sims[i] for i in cand]),
        )
        cand = [cand[j] for j in np.argsort(-scores)]
        top = cand[:5]
        pick = assets[random.choice(top)]
        return {
            "object_name": object_name,
            "object_id": os.path.splitext(os.path.basename(pick))[0],
            "object_path": pick,
        }
    raise AssetNotFound(
        f"No local asset library ({ASSET_DIR_ENV} unset) and no network "
        f"Objaverse access; cannot retrieve '{object_name}'."
    )


MESHY_API = "https://api.meshy.ai/v2/text-to-3d"


def _meshy_request(url: str, api_key: str, payload=None) -> Dict:
    import json as _json
    import urllib.request

    req = urllib.request.Request(
        url,
        data=_json.dumps(payload).encode() if payload is not None
        else None,
        headers={
            "Authorization": f"Bearer {api_key}",
            "Content-Type": "application/json",
        },
        method="POST" if payload is not None else "GET",
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return _json.loads(r.read())


def _meshy_poll(task_id: str, api_key: str, interval: float = 5.0,
                timeout: float = 600.0) -> Dict:
    import time

    t0 = time.time()
    while True:
        task = _meshy_request(f"{MESHY_API}/{task_id}", api_key)
        if task.get("status") in ("SUCCEEDED", "FAILED", "EXPIRED"):
            return task
        if time.time() - t0 > timeout:
            raise TimeoutError(f"meshy task {task_id} timed out")
        time.sleep(interval)


def retrieve_asset_from_meshy(
    object_name: str, out_dir: Optional[str] = None
) -> Dict:
    """Meshy text-to-3D (wrapper_objaverse.py:226-317): preview task →
    poll → refine task → poll → download GLB.  Needs MESHY_API_KEY and
    network egress; any failure falls back to the local library."""
    api_key = os.environ.get("MESHY_API_KEY")
    if not api_key:
        return retrieve_asset_from_objaverse(object_name)
    try:
        prev = _meshy_request(
            MESHY_API, api_key,
            {"mode": "preview", "prompt": object_name,
             "art_style": "realistic"},
        )
        task = _meshy_poll(prev["result"], api_key)
        if task.get("status") != "SUCCEEDED":
            raise RuntimeError(f"meshy preview failed: {task}")
        ref = _meshy_request(
            MESHY_API, api_key,
            {"mode": "refine", "preview_task_id": prev["result"]},
        )
        task = _meshy_poll(ref["result"], api_key)
        if task.get("status") != "SUCCEEDED":
            raise RuntimeError(f"meshy refine failed: {task}")
        url = task["model_urls"]["glb"]
        import urllib.request

        out_dir = out_dir or os.path.join(
            os.path.expanduser("~"), ".cache", "autovfx_meshy"
        )
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, "_".join(object_name.split()) + ".glb"
        )
        urllib.request.urlretrieve(url, path)
        return {
            "object_name": object_name,
            "object_path": path,
            "source": "meshy",
        }
    except Exception as e:  # noqa: BLE001 — offline/API failure → local
        print(f"meshy retrieval failed ({e}); using local library")
        return retrieve_asset_from_objaverse(object_name)


def retrieve_materials_from_polyhaven(material_name: str) -> Optional[str]:
    """SBERT similarity over material folder names, random of top-5
    (wrapper_polyhaven.py:27-50)."""
    root = os.environ.get(MATERIAL_DIR_ENV, "")
    if not root or not os.path.isdir(root):
        return None
    folders = sorted(
        d for d in glob.glob(os.path.join(root, "*")) if os.path.isdir(d)
    )
    if not folders:
        return None
    names = [os.path.basename(f).replace("_", " ") for f in folders]
    sims = _similarity_rank(material_name, names)
    top = list(np.argsort(-sims)[:5])
    return folders[random.choice(top)]


# ---- ChatSim vehicle bank (edit_utils.py:582-605) ---------------------------------

_CHATSIM_VEHICLES = [
    "ambulance", "benz_g", "benz_s", "bmw_mini", "cadillac", "chevrolet",
    "citroen", "dodge", "ferrari", "fire_truck", "ford_mustang", "jeep",
    "lamborghini", "land_rover", "mclaren", "mercedes", "mini_bus",
    "pickup", "police_car", "school_bus", "tesla_cybertruck", "van",
]


def retrieve_chatsim_vehicle(object_name: str) -> Dict:
    sims = _similarity_rank(
        object_name, [v.replace("_", " ") for v in _CHATSIM_VEHICLES]
    )
    vid = _CHATSIM_VEHICLES[int(np.argmax(sims))]
    root = os.environ.get(ASSET_DIR_ENV, "")
    path = os.path.join(root, "chatsim", f"{vid}.glb") if root else ""
    if not path or not os.path.exists(path):
        # fall back to generic asset search
        return retrieve_asset_from_objaverse(object_name)
    return {
        "object_id": vid,
        "object_path": path,
        "forward_axis": "TRACK_NEGATIVE_Y",
    }
