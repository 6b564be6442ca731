"""GPT-4V estimators: an object's real-world scale and forward axis.

A copy of ``autovfx_tpu/perception/gpt4v.py`` (the reference's
``gpt/gpt4v_utils.py``: estimate_object_scale :18-84,
estimate_object_forward_axis :87-135).  It calls the OpenAI API when
``OPENAI_API_KEY`` is set (the same prompts and contract); otherwise it
answers from a deterministic size table, so the pipeline runs offline.
One repair: the key is checked before ``requests`` is imported, so the
offline table answers on a machine without ``requests``.
"""
from __future__ import annotations

import base64
import json
import os
import re
from typing import Optional

# common object sizes in meters (fallback when no API access)
_SIZE_TABLE = {
    "basketball": 0.24,
    "soccer ball": 0.22,
    "ball": 0.22,
    "tennis ball": 0.067,
    "apple": 0.08,
    "orange": 0.08,
    "cup": 0.1,
    "mug": 0.1,
    "bottle": 0.25,
    "vase": 0.3,
    "chair": 0.9,
    "table": 1.2,
    "sofa": 1.8,
    "couch": 1.8,
    "dog": 0.6,
    "cat": 0.4,
    "car": 4.5,
    "truck": 7.0,
    "bus": 11.0,
    "tree": 5.0,
    "plant": 0.6,
    "flower": 0.3,
    "book": 0.25,
    "laptop": 0.35,
    "lamp": 0.5,
    "box": 0.4,
    "rock": 0.3,
    "statue": 1.0,
    "toy": 0.2,
    "robot": 1.0,
}
_DEFAULT_SIZE = 0.5


def _encode_image(path: str) -> str:
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


def _openai_chat(messages, model="gpt-4o-2024-05-13", max_tokens=300):
    key = os.environ.get("OPENAI_API_KEY")
    if not key:
        return None
    import requests

    resp = requests.post(
        "https://api.openai.com/v1/chat/completions",
        headers={"Authorization": f"Bearer {key}"},
        json={
            "model": model,
            "messages": messages,
            "max_tokens": max_tokens,
        },
        timeout=120,
    )
    resp.raise_for_status()
    return resp.json()["choices"][0]["message"]["content"]


def estimate_object_scale(
    img_path: Optional[str], object_name: Optional[str]
) -> float:
    """Longest-dimension size in meters (gpt4v_utils.py:18-84)."""
    content = [
        {
            "type": "text",
            "text": (
                "Estimate the real-world size (longest dimension, in "
                "meters) of the object"
                + (f" named '{object_name}'" if object_name else "")
                + " shown. Answer with JSON {\"size\": <meters>} only."
            ),
        }
    ]
    if img_path and os.path.exists(img_path):
        content.append(
            {
                "type": "image_url",
                "image_url": {
                    "url": "data:image/png;base64,"
                    + _encode_image(img_path)
                },
            }
        )
    answer = _openai_chat([{"role": "user", "content": content}])
    if answer:
        m = re.search(r"[-+]?\d*\.?\d+", answer)
        if m:
            return float(m.group())
    # offline fallback: size table by name substring
    name = (object_name or "").lower()
    for key in sorted(_SIZE_TABLE, key=len, reverse=True):
        if key in name:
            return _SIZE_TABLE[key]
    return _DEFAULT_SIZE


def estimate_object_forward_axis(img_folder: str, object_name: str) -> str:
    """Frontal-view index -> Blender forward axis (gpt4v_utils.py:87-135,
    mapping :131-133)."""
    mapping = {
        0: "TRACK_NEGATIVE_Y",
        1: "FORWARD_X",
        2: "FORWARD_Y",
        3: "TRACK_NEGATIVE_X",
    }
    import glob

    imgs = sorted(glob.glob(os.path.join(img_folder, "*.png")))[:4]
    if imgs:
        content = [
            {
                "type": "text",
                "text": (
                    f"These 4 images show a {object_name} from 4 sides. "
                    "Which image index (0-3) shows its FRONT? Answer with "
                    'JSON {"index": <0-3>} only.'
                ),
            }
        ] + [
            {
                "type": "image_url",
                "image_url": {
                    "url": "data:image/png;base64," + _encode_image(p)
                },
            }
            for p in imgs
        ]
        answer = _openai_chat([{"role": "user", "content": content}])
        if answer:
            m = re.search(r"\d", answer)
            if m and int(m.group()) in mapping:
                return mapping[int(m.group())]
    return "TRACK_NEGATIVE_Y"
