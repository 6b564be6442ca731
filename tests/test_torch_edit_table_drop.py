"""The drop of ``chip_smoke.py``'s edit program (a 0.3 m cube onto a
0.6 m square table 1.0 m high, its center 0.4 m ahead of the first ring
camera) through the port's ``run_physics`` against the JAX package's, on
the CPU, at both landing points of ``sample_point_on_object`` (the
centroids of the top's two triangles) and at two drop heights.

The table and the ring are the card's; the scene is 400 splats, since
the physics sees only the scene mesh and the cube.  Bounds:
``rb_transform`` within ``tests/test_physics_golden.py``'s.  Both
packages rest the cube on the top by the last of the 8 frames when it
is dropped 0.3 m above the landing point.  From the DSL's default 0.6 m
both still hold it 3-4.5 cm up at the last frame (the speculative
contacts slow its last approach), which is why the card's program
passes ``VERTICAL_OFFSET=0.3``.
"""
import os
import sys

import numpy as np
import jax
import pytest

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.core import ply_io as JPLY
from autovfx_tpu.edit import mesh_io as JMIO
from autovfx_tpu.utils.synthetic import make_gaussians

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_edit import box_mesh, box_object, ground_mesh  # noqa: E402
from test_torch_edit import insert_both, rb_close, scenes  # noqa: E402

SIDE, TOP, AHEAD, RING, LENS = 0.6, 1.0, 0.4, 2.6, 1.4
REST = TOP + 0.15  # the 0.3 m cube's center on the top
FRAMES = 8


def table_mesh():
    """The ground quad and the table box: the square's sides along and
    across the first camera's view, its top split along the diagonal
    from the near corner on the camera's left to the far one on its
    right, counterclockwise from above as the card's."""
    c, a, s, hs = np.array([RING - AHEAD, 0.0]), np.array([-1.0, 0.0]), \
        np.array([0.0, -1.0]), SIDE / 2
    ring = [c - hs * a + hs * s, c - hs * a - hs * s, c + hs * a - hs * s,
            c + hs * a + hs * s]
    v = np.array([[x, y, z] for z in (0.0, TOP) for x, y in ring],
                 np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5],
                  [0, 5, 4], [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6],
                  [3, 0, 4], [3, 4, 7]], np.int64)
    gm = ground_mesh()
    return JMIO.Mesh(np.concatenate([gm.vertices, v]),
                     np.concatenate([gm.faces, f + 4])), v


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("table"))
    g = make_gaussians(400, jax.random.PRNGKey(0), spread=1.5,
                       scale_range=(0.02, 0.08))
    JPLY.save_ply(os.path.join(root, "scene.ply"), g)
    mesh, v = table_mesh()
    JMIO.save_obj(os.path.join(root, "mesh.obj"), mesh)
    cams = JC.stack_cameras([
        JC.look_at_camera([RING * np.cos(a), RING * np.sin(a), LENS],
                          [0, 0, 0.2], [0, 0, 1], fx=24.0, fy=24.0,
                          width=32, height=21)
        for a in np.linspace(0, 2 * np.pi, FRAMES, endpoint=False)])
    JC.save_custom_trajectory(
        os.path.join(root, "custom_camera_path", "ring.json"), cams)
    JMIO.save_obj(os.path.join(root, "cube.obj"), box_mesh())
    params = dict(source_path=root, model_path=root,
                  gaussians_ckpt_path=os.path.join(root, "scene.ply"),
                  scene_mesh_path=os.path.join(root, "mesh.obj"),
                  custom_traj_name="ring", dup_budget=1 << 14)
    top = v[4:]
    landings = {"near": top[[0, 1, 2]].mean(0), "far": top[[0, 2, 3]].mean(0)}
    return root, params, landings


@pytest.mark.parametrize("offset,landing", [
    (0.3, "near"), (0.3, "far"), (0.6, "near"), (0.6, "far")])
def test_table_drop_matches_jax(table, offset, landing):
    root, params, landings = table
    js, ts = scenes(os.path.join(root, f"{offset}_{landing}"), params)
    pos = landings[landing] + np.array([0.0, 0.0, offset], np.float32)
    insert_both(js, ts, box_object(os.path.join(root, "cube.obj"), "cube",
                                   pos), "allow_physics")
    js.run_physics()
    ts.run_physics()
    rb_close(ts.rb_transform, js.rb_transform)
    for scene in (js, ts):
        rb = scene.rb_transform["cube"]
        z = np.array([rb[str(f)]["pos"][2] for f in range(FRAMES)])
        assert z.min() >= REST - 1e-3, z  # never into the top
        np.testing.assert_allclose(rb[str(FRAMES - 1)]["pos"][:2], pos[:2],
                                   atol=1e-3)
        if offset == 0.3:
            assert abs(z[-1] - REST) <= 1e-3, z
        else:
            assert 0.03 <= z[-1] - REST <= 0.045, z
