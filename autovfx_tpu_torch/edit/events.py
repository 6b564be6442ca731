"""Per-frame event system for time-varying edits.

Parity target: ``blender/all_rendering.py:1969-2124`` — the event
parser/action map and per-frame handler: events {object_id, event_type,
start_frame, end_frame} toggle physics ('physics'), fire ('fire'),
smoke ('smoke'), trigger fracture at a frame ('break'), incinerate, and
melting; defaults from edit_utils.add_event (:521-536 — break/incinerate
start at total_frames // 2).

TPU-first: instead of mutating a live Blender scene per frame, events
compile into per-frame boolean schedules (frames × bodies) that the
jitted physics scan and the render passes consume directly.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

EVENT_TYPES = (
    "physics",
    "fire",
    "smoke",
    "break",
    "incinerate",
    "melting",
)


def compile_event_schedule(
    events: List[Dict],
    object_ids: List[str],
    total_frames: int,
) -> Dict[str, np.ndarray]:
    """Events -> dense (frames, bodies) bool schedules per event type.

    A schedule cell is True when the effect is active for that body at
    that frame (start_frame ≤ frame+1 < end_frame, 1-based like the
    reference's frame indices).
    """
    idx = {oid: i for i, oid in enumerate(object_ids)}
    n = len(object_ids)
    out = {
        t: np.zeros((total_frames, n), bool) for t in EVENT_TYPES
    }
    for ev in events:
        t = ev.get("event_type")
        if t not in out:
            continue
        oid = ev.get("object_id")
        if oid not in idx:
            continue
        start = int(ev.get("start_frame") or 1)
        end = ev.get("end_frame")
        end = int(end) if end is not None else total_frames + 1
        f0 = max(start - 1, 0)
        f1 = min(end - 1, total_frames)
        out[t][f0:f1, idx[oid]] = True
    return out


def physics_enabled_schedule(
    objects: List[Dict],
    events: List[Dict],
    total_frames: int,
) -> np.ndarray:
    """(frames, bodies) bool: rigid-body simulation active.

    Bodies default to their ``rigid_body.rb_type == ACTIVE`` flag; a
    'physics' event window overrides (the reference's start/stop physics
    handler, all_rendering.py:2028-2060).
    """
    ids = [o["object_id"] for o in objects]
    sched = compile_event_schedule(events, ids, total_frames)["physics"]
    base = np.array(
        [
            str((o.get("rigid_body") or {}).get("rb_type", "")).upper()
            == "ACTIVE"
            for o in objects
        ],
        bool,
    )
    has_phys_event = np.zeros(len(ids), bool)
    for ev in events:
        if ev.get("event_type") == "physics" and ev.get("object_id") in ids:
            has_phys_event[ids.index(ev["object_id"])] = True
    out = np.broadcast_to(base, (total_frames, len(ids))).copy()
    out[:, has_phys_event] = sched[:, has_phys_event]
    return out
