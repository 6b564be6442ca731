"""Precomputed Objaverse embedding index and download client.

A copy of ``autovfx_tpu/retrieval/objaverse_index.py`` (numpy only; the
port imports nothing of the JAX package): the reference's SBERT
embedding databases and SCaNN search over Objaverse asset names
(``retrieval/wrapper_objaverse.py:20-59``), its GObjaverse preview
download (``:94-112,175-181``) and ``objaverse.load_objects``
(``:82-91``), redesigned as

* **Index format**: one ``.npz`` with L2-normalized float32 ``database``
  (N, D), ``uids`` (N,) unicode, optional ``animated`` (N,) bool (the
  reference's second, animated database as a mask), optional
  ``gobj_index`` (N,) unicode (the GObjaverse path fragment) and a
  ``meta`` JSON string naming the embedder.  No pickle.
* **Search**: exact top-k by one (1, D) x (D, N) product in numpy.
* **Embedder**: SBERT when a local model cache exists; otherwise a
  deterministic feature-hashing bag of words, so the index works
  offline.  The index records its embedder and the query is embedded
  the same way.
* **Downloads**: ``download_objects`` takes files already present, then
  a local mirror (``AUTOVFX_OBJAVERSE_MIRROR``), then the ``objaverse``
  package where it imports; offline, a miss is dropped (a no-op, never
  an exception), so the caller's local library stays in charge.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

INDEX_ENV = "AUTOVFX_OBJAVERSE_INDEX"
MIRROR_ENV = "AUTOVFX_OBJAVERSE_MIRROR"
HASH_DIM = 256
FORMAT_VERSION = 1


# ---------------------------------------------------------------- embedding
def _hash_embed(texts: Sequence[str], dim: int = HASH_DIM) -> np.ndarray:
    """Deterministic feature-hashing bag-of-words embedding.

    Each lowercase token is hashed (blake2b) to a bucket and a sign;
    vectors are L2-normalized.  Shared tokens between query and asset
    names produce positive cosine similarity — the same signal the
    SBERT db encodes, at lower quality, with zero model weights.
    """
    out = np.zeros((len(texts), dim), np.float32)
    for i, text in enumerate(texts):
        for tok in re.split(r"[^a-z0-9]+", text.lower()):
            if not tok:
                continue
            h = hashlib.blake2b(tok.encode(), digest_size=8).digest()
            bucket = int.from_bytes(h[:4], "little") % dim
            sign = 1.0 if h[4] & 1 else -1.0
            out[i, bucket] += sign
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-12)


def _sbert_embed(texts: Sequence[str]) -> Optional[np.ndarray]:
    try:
        from autovfx_tpu_torch.retrieval.wrappers import _hub_offline_first

        with _hub_offline_first():
            from sentence_transformers import SentenceTransformer

            model = SentenceTransformer("all-mpnet-base-v2")
            em = model.encode(list(texts), normalize_embeddings=True,
                              show_progress_bar=False)
        return np.asarray(em, np.float32)
    except Exception:
        return None


def embed_texts(texts: Sequence[str], embedder: str = "auto") -> Tuple[np.ndarray, str]:
    """Embed texts; returns (embeddings, embedder_name_used)."""
    if embedder in ("auto", "sbert"):
        em = _sbert_embed(texts)
        if em is not None:
            return em, "sbert:all-mpnet-base-v2"
        if embedder == "sbert":
            raise RuntimeError("SBERT requested but unavailable offline")
    return _hash_embed(texts), f"hash:{HASH_DIM}"


# ------------------------------------------------------------------- index
@dataclass
class ObjaverseIndex:
    """In-memory view of a precomputed embedding DB."""

    database: np.ndarray  # (N, D) float32, rows L2-normalized
    uids: np.ndarray  # (N,) unicode
    embedder: str
    animated: Optional[np.ndarray] = None  # (N,) bool
    gobj_index: Optional[np.ndarray] = None  # (N,) unicode

    def __post_init__(self):
        assert self.database.ndim == 2
        assert len(self.uids) == len(self.database)

    def save(self, path: str) -> None:
        meta = {"version": FORMAT_VERSION, "embedder": self.embedder}
        arrays = dict(
            database=self.database.astype(np.float32),
            uids=np.asarray(self.uids, dtype="U"),
            meta=np.asarray(json.dumps(meta)),
        )
        if self.animated is not None:
            arrays["animated"] = np.asarray(self.animated, bool)
        if self.gobj_index is not None:
            arrays["gobj_index"] = np.asarray(self.gobj_index, dtype="U")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "ObjaverseIndex":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("version") != FORMAT_VERSION:
                raise ValueError(
                    f"objaverse index version {meta.get('version')} != "
                    f"{FORMAT_VERSION}"
                )
            return cls(
                database=z["database"],
                uids=z["uids"],
                embedder=meta["embedder"],
                animated=z["animated"] if "animated" in z.files else None,
                gobj_index=(
                    z["gobj_index"] if "gobj_index" in z.files else None
                ),
            )

    def search(
        self,
        query: str,
        top_k: int = 10,
        cosine_threshold: float = 0.6,
        animated_only: bool = False,
    ) -> Tuple[List[str], List[float]]:
        """Exact top-k cosine search (SCaNN-equivalent; see module doc).

        Matches the reference's recipe: SEARCH_TOP_K=10 neighbors,
        COSINE_THRESHOLD=0.6 filter (wrapper_objaverse.py:159-167).
        """
        qvec, used = embed_texts([query], embedder=_embedder_kind(self.embedder))
        if used != self.embedder:
            raise RuntimeError(
                f"query embedder {used!r} != index embedder "
                f"{self.embedder!r} — rebuild the index or install the model"
            )
        sims = self.database @ qvec[0]
        if animated_only:
            if self.animated is None:
                return [], []
            sims = np.where(self.animated, sims, -np.inf)
        k = min(top_k, len(sims))
        if k <= 0:  # empty index: argpartition(k-1) would raise
            return [], []
        top = np.argpartition(-sims, k - 1)[:k]
        top = top[np.argsort(-sims[top])]
        keep = [i for i in top if sims[i] >= cosine_threshold]
        return [str(self.uids[i]) for i in keep], [float(sims[i]) for i in keep]

    def gobj_paths(self, uids: Iterable[str]) -> Dict[str, str]:
        """uid → GObjaverse path fragment (the reference's id2idx dict,
        wrapper_objaverse.py:26,151-153)."""
        if self.gobj_index is None:
            return {}
        lut = {str(u): str(g) for u, g in zip(self.uids, self.gobj_index)}
        return {u: lut[u] for u in uids if u in lut}


def _embedder_kind(name: str) -> str:
    return "sbert" if name.startswith("sbert") else "hash"


def build_index(
    entries: Dict[str, Dict],
    out_path: Optional[str] = None,
    embedder: str = "auto",
) -> ObjaverseIndex:
    """Build an index from ``{uid: {"name": ..., "tags": [...],
    "animated": bool, "gobj_index": "0/123"}}`` metadata.

    The embedded text is ``name`` + space-joined ``tags`` — the same
    caption-ish text the reference's precomputed SBERT db was built
    from (Cap3D-style names; wrapper_objaverse.py:20-26).
    """
    uids = sorted(entries)
    texts = []
    animated = np.zeros(len(uids), bool)
    gobj = np.asarray([""] * len(uids), dtype="U64")
    has_gobj = False
    for i, uid in enumerate(uids):
        e = entries[uid]
        text = str(e.get("name", uid))
        tags = e.get("tags") or []
        if tags:
            text = text + " " + " ".join(map(str, tags))
        texts.append(text)
        animated[i] = bool(e.get("animated", False))
        if e.get("gobj_index"):
            gobj[i] = str(e["gobj_index"])
            has_gobj = True
    database, used = embed_texts(texts, embedder=embedder)
    index = ObjaverseIndex(
        database=database,
        uids=np.asarray(uids, dtype="U"),
        embedder=used,
        animated=animated if animated.any() else None,
        gobj_index=gobj if has_gobj else None,
    )
    if out_path:
        index.save(out_path)
    return index


def default_index_path() -> Optional[str]:
    """Resolve the index file: $AUTOVFX_OBJAVERSE_INDEX, else the
    conventional cache location if it exists."""
    p = os.environ.get(INDEX_ENV)
    if p:
        return p if os.path.exists(p) else None
    p = os.path.join(
        os.environ.get("AUTOVFX_CACHE_DIR", "_cache"), "objaverse_index.npz"
    )
    return p if os.path.exists(p) else None


# --------------------------------------------------------------- downloads
def download_objects(uids: Sequence[str], save_dir: str) -> Dict[str, str]:
    """uid → local glb path.  Resolution order:

    1. already present in ``save_dir``;
    2. a local mirror dir ($AUTOVFX_OBJAVERSE_MIRROR/<uid>.glb);
    3. the ``objaverse`` package (network deployments —
       wrapper_objaverse.py:82-91's ``objaverse.load_objects``).

    Offline misses are silently dropped (no-op, never raises) so the
    caller's local-library fallback stays in charge.
    """
    os.makedirs(save_dir, exist_ok=True)
    out: Dict[str, str] = {}
    missing = []
    mirror = os.environ.get(MIRROR_ENV, "")
    for uid in uids:
        local = os.path.join(save_dir, f"{uid}.glb")
        if os.path.exists(local):
            out[uid] = local
            continue
        if mirror:
            hits = glob.glob(os.path.join(mirror, "**", f"{uid}.glb"),
                             recursive=True)
            if hits:
                out[uid] = hits[0]
                continue
        missing.append(uid)
    if missing:
        try:
            import shutil

            import objaverse  # type: ignore

            paths = objaverse.load_objects(missing)
            for uid, src in paths.items():
                dst = os.path.join(save_dir, f"{uid}.glb")
                shutil.move(src, dst)
                out[uid] = dst
        except Exception as e:  # noqa: BLE001 — offline → partial result
            print(f"# objaverse download unavailable ({e}); "
                  f"{len(missing)} uid(s) unresolved")
    return out


def download_gobjaverse_previews(
    uid_to_index: Dict[str, str], save_dir: str, views: int = 40,
    min_views: int = 4, timeout_s: float = 20.0,
) -> Dict[str, str]:
    """uid → local preview folder with the GObjaverse pre-rendered
    turntable views (wrapper_objaverse.py:94-112).  Already-present
    complete folders (>= ``min_views`` images) are reused.

    Network use is opt-in (AUTOVFX_ALLOW_HUB_DOWNLOAD=1, same switch as
    the HF hub paths) and every request carries ``timeout_s`` so a
    packet-dropping host can't stall retrieval; a uid is only registered
    once at least ``min_views`` views landed, so a partial folder is
    retried next call instead of being reused forever.
    """
    base = ("https://virutalbuy-public.oss-cn-hangzhou.aliyuncs.com/"
            "share/aigc3d/objaverse")
    allow_net = os.environ.get("AUTOVFX_ALLOW_HUB_DOWNLOAD") == "1"
    out: Dict[str, str] = {}
    for uid, idx in uid_to_index.items():
        folder = os.path.join(save_dir, uid)
        if os.path.isdir(folder) and len(os.listdir(folder)) >= min_views:
            out[uid] = folder
            continue
        if not allow_net:
            print(f"# gobjaverse previews for {uid} not cached and "
                  "downloads disabled (set AUTOVFX_ALLOW_HUB_DOWNLOAD=1)")
            continue
        os.makedirs(folder, exist_ok=True)
        got = 0
        try:
            import urllib.request

            for v in range(views):
                name = f"{v:05d}"
                url = f"{base}/{idx}/campos_512_v4/{name}/{name}.png"
                with urllib.request.urlopen(url, timeout=timeout_s) as r:
                    data = r.read()
                with open(os.path.join(folder, f"{name}.png"), "wb") as f:
                    f.write(data)
                got += 1
        except Exception as e:  # noqa: BLE001 — offline → skip uid
            if got < min_views:
                print(f"# gobjaverse previews unavailable for {uid} ({e})")
        if got >= min_views:
            out[uid] = folder
    return out
