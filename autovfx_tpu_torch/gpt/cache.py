"""Disk cache for LLM calls (gpt/LLM_cache.py:10-55 parity):
sha1(json(kwargs)) -> pickle file, making reruns reproducible."""
from __future__ import annotations

import hashlib
import json
import os
import pickle
from typing import Any, Optional


class DiskCache:
    def __init__(self, cache_dir: str = "_cache/llm_cache"):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _path(self, kwargs: dict) -> str:
        key = hashlib.sha1(
            json.dumps(kwargs, sort_keys=True, default=str).encode()
        ).hexdigest()
        return os.path.join(self.cache_dir, key + ".pkl")

    def get(self, kwargs: dict) -> Optional[Any]:
        p = self._path(kwargs)
        if os.path.exists(p):
            with open(p, "rb") as f:
                return pickle.load(f)
        return None

    def put(self, kwargs: dict, value: Any) -> None:
        with open(self._path(kwargs), "wb") as f:
            pickle.dump(value, f)

    def __contains__(self, kwargs: dict) -> bool:
        return os.path.exists(self._path(kwargs))
