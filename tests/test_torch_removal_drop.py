"""The ball drop of ``chip_smoke.py``'s removal program through the port's
``run_physics`` against the JAX package's, on the CPU.

After the table is removed, the scene mesh is the ground quad, the
table's faces that no ring view sees (its bottom and the side facing the
first camera, which the extraction leaves in the removal mesh) and the
convex-hull patch over its footprint.  The ball is
``chip_smoke.icosphere`` (42 vertices, all in the solver's hull) at the
GPT-4V size table's 0.24 m.  Both packages, within
``tests/test_physics_golden.py``'s bounds of each other:

- dropped with its center 0.15 m above the footprint's center, the
  ball lies behind the leftover side's plane and is pushed out through
  it, to 0.15 m outside the footprint;
- dropped there 0.15 m beyond the center, away from the first camera
  (the card's program), it rests on the patch by the 3rd of the 8
  frames: still over the last three, its lowest vertex less than
  ``chip_smoke.BALL_SINK_MAX`` below the patch's plane, the contact
  inside the patch;
- dropped from 0.3 m above the table's top, the program the removal was
  first written with, it is still moving at the last frame.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from test_torch_edit import box_object, insert_both, rb_close  # noqa: E402
from test_torch_edit import scenes  # noqa: E402
from test_torch_edit_table_drop import (  # noqa: E402
    FRAMES,
    JMIO,
    table,  # noqa: F401  (the fixture)
    table_mesh,
)
from autovfx_tpu_torch.core.quaternion import euler_to_rotmat  # noqa: E402

CENTER = np.array([2.2, 0.0])  # the footprint's center
AWAY = np.array([-1.0, 0.0])  # away from the first camera, on the ground


def removal_mesh():
    """The ground, the table's bottom and near side, and the patch fanned
    from the footprint's center, as ``inpaint_object`` merges them."""
    mesh, v = table_mesh()
    keep = np.concatenate([[0, 1], 2 + np.array([0, 1, 4, 5])])
    ring = v[:4, :2]
    patch_v = np.concatenate([[[*CENTER, 0.0]],
                              np.column_stack([ring, np.zeros(4)])])
    patch_f = np.array([[0, 1 + i, 1 + (i + 1) % 4] for i in range(4)])
    return JMIO.Mesh(
        np.concatenate([mesh.vertices, patch_v]).astype(np.float32),
        np.concatenate([mesh.faces[keep], patch_f + len(mesh.vertices)])), \
        ring


@pytest.fixture(scope="module")
def removed(table):
    root, params, _ = table
    mesh, ring = removal_mesh()
    path = os.path.join(root, "removal_mesh.obj")
    JMIO.save_obj(path, mesh)
    v, f = cs.icosphere()
    ball = os.path.join(root, "ball.obj")
    JMIO.save_obj(ball, JMIO.Mesh(vertices=v, faces=f))
    return root, dict(params, scene_mesh_path=path), ball, ring


def drop(removed, name, pos):
    root, params, ball, _ = removed
    js, ts = scenes(os.path.join(root, name), params)
    insert_both(js, ts, box_object(ball, "ball", pos, scale=cs.BALL_SIZE),
                "allow_physics")
    js.run_physics()
    ts.run_physics()
    rb_close(ts.rb_transform, js.rb_transform)
    return [scene.rb_transform["ball"] for scene in (js, ts)]


def lowest(rb, frame, ball):
    pose = rb[str(frame)]
    rot = euler_to_rotmat(*[float(x) for x in pose["rot"]]).numpy()
    v = JMIO.load_mesh(ball).normalized_to_unit_box().vertices
    world = (v * pose["scale"][0]) @ rot.T + np.asarray(pose["pos"])
    return world[np.argmin(world[:, 2])]


def test_a_ball_behind_the_leftover_side_is_pushed_out(removed):
    for rb in drop(removed, "center", [*CENTER, cs.BALL_DROP]):
        x = rb[str(FRAMES - 1)]["pos"][0]
        assert x > 2.5 + 0.12, x  # beyond the near side, clear of it


def test_the_programs_drop_rests_on_the_patch(removed):
    _, _, ball, ring = removed
    pos = [*(CENTER + cs.BALL_AWAY * AWAY), cs.BALL_DROP]
    margin = 1e-3  # the solver's collision margin
    for rb in drop(removed, "away", pos):
        z = np.array([rb[str(f)]["pos"][2] for f in range(FRAMES)])
        assert np.abs(z[-cs.REST_FRAMES:] - z[-1]).max() <= margin, z
        low = lowest(rb, FRAMES - 1, ball)
        assert -cs.BALL_SINK_MAX <= low[2] <= margin, low
        assert cs.in_convex(low[None, :2], ring)[0], low


def test_from_above_the_top_it_still_moves(removed):
    for rb in drop(removed, "top", [*CENTER, 1.0 + 0.3]):
        z = np.array([rb[str(f)]["pos"][2] for f in range(FRAMES)])
        assert abs(z[-1] - z[-2]) > 1e-3, z
