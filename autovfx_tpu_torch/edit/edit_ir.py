"""The JSON edit IR — the de-facto intermediate representation of an edit.

Parity target: the Blender config JSON written by
``scene_representation.set_basic_blender_cfg`` (:240-256) + object/event
arrays (:261-275), read back with ``rb_transform`` results
(all_rendering.py:2160-2193 reader, :2587-2591 writeback).  SURVEY §5
flags this schema as the cross-process contract to preserve; here it
also serves as the replayable record of an edit (the renderer is
in-process, but the IR still round-trips through JSON for caching,
debugging and external tools).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


def _to_jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    return x


@dataclass
class EditConfig:
    """Field-for-field mirror of the reference Blender cfg JSON."""

    edit_text: str = ""
    blender_cache_dir: str = ""
    im_width: int = 1296
    im_height: int = 840
    K: List[List[float]] = field(default_factory=lambda: [[0.0] * 3] * 3)
    c2w: List[Any] = field(default_factory=list)  # (F, 4, 4)
    scene_mesh_path: str = ""
    is_uv_mesh: bool = False
    output_dir_name: str = "blender_output"
    render_type: str = "MULTI_VIEW"  # or SINGLE_VIEW
    num_frames: int = 1
    anchor_frame_idx: int = 0
    emitter_mesh_path: Optional[str] = None
    is_indoor_scene: bool = False
    waymo_scene: bool = False
    global_env_map_path: str = ""
    sun_dir: Optional[List[float]] = None
    insert_object_info: List[Dict] = field(default_factory=list)
    fire_objects: List[str] = field(default_factory=list)
    smoke_objects: List[str] = field(default_factory=list)
    events: List[Dict] = field(default_factory=list)
    # output (written back after simulation, like Blender did)
    rb_transform: Optional[Dict] = None
    scene_scale: float = 1.0
    fps: float = 15.0

    def to_json(self, path: Optional[str] = None) -> str:
        payload = json.dumps(_to_jsonable(asdict(self)), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(payload)
        return payload

    @classmethod
    def from_json(cls, path_or_str: str) -> "EditConfig":
        if path_or_str.lstrip().startswith("{"):
            data = json.loads(path_or_str)
        else:
            with open(path_or_str) as f:
                data = json.load(f)
        known = {f_.name for f_ in cls.__dataclass_fields__.values()}
        return cls(**{k: v for k, v in data.items() if k in known})


def default_object_info() -> Dict:
    """get_default_object_info parity (edit_utils.py:67-92)."""
    return {
        "object_name": "object",
        "object_id": "object_id",
        "object_path": "path/to/object.obj",
        "pos": np.zeros(3, np.float32),
        "rot": np.eye(3, dtype=np.float32),
        "scale": 1.0,
        "from_3DGS": False,
        "forward_axis": "TRACK_NEGATIVE_Y",
        "animation": None,
        "rigid_body": {
            "rb_type": "PASSIVE",
            "collision_shape": "MESH",
            "mass": 1.0,
            "restitution": 0.5,
        },
        "material": None,
        "fracture": False,
        "break": False,
        "melting": False,
        "incinerate": False,
    }


def default_event_info() -> Dict:
    """get_default_event_info parity (edit_utils.py:95-104)."""
    return {
        "object_id": "dummy",
        "event_type": "dummy",
        "start_frame": 1,
        "end_frame": None,
    }
