"""The port's rigid-body physics against the JAX package's, on the CPU.

- ``build_hulls`` / ``build_mesh_grid``: equal arrays;
- ``mesh_contact_query``, ``mesh_closest_triangle``: within 1e-5;
- ``simulate`` of the bench's cube drop (``bench.py:139-165``, 8
  frames): centers of mass within 1e-3 m and quaternions within 1e-3 of
  JAX's, and the port's solver against itself, run twice, bit-equal;
- the three committed trajectory goldens
  (``tests/golden/physics_{drop,tumble,stack}.npz``) within the bounds
  of ``tests/test_physics_golden.py:98-130``;
- a kinematic body and an ``enabled_schedule`` against JAX;
- ``animation`` and ``rb_transform_schema`` against JAX.
"""
import os
import sys

import numpy as np
import pytest
import torch

from autovfx_tpu.physics import animation as JANIM
from autovfx_tpu.physics import shapes as JSHP
from autovfx_tpu.physics import solver as JS
from autovfx_tpu.physics import world as JW
from autovfx_tpu_torch.physics import animation as ANIM
from autovfx_tpu_torch.physics import shapes as SHP
from autovfx_tpu_torch.physics import solver as S
from autovfx_tpu_torch.physics import world as W

sys.path.insert(0, os.path.dirname(__file__))

import test_physics_golden as G  # noqa: E402

POS_TOL, QUAT_TOL = 1e-3, 1e-3


def cube(half=0.3):
    return np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                     for z in (-half, half)], np.float32)


GROUND_V = np.array([[-5, -5, 0.3], [5, -5, 0.3], [5, 5, 0.3],
                     [-5, 5, 0.3]], np.float32)
GROUND_F = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
DROP = [{"pos": [0.0, 0.0, 1.5], "scale": 1.0,
         "rigid_body": {"rb_type": "ACTIVE", "mass": 1.0,
                        "restitution": 0.4}}]


def worlds(objects, verts, ground_v=GROUND_V, ground_f=GROUND_F):
    """The same world built by both packages: (JAX, port on the CPU)."""
    kw = dict(scene_vertices=ground_v, scene_faces=ground_f)
    return (JW.RigidWorld.from_objects(objects, verts, cfg=JS.SolverConfig(),
                                       **kw),
            W.RigidWorld.from_objects(objects, verts, cfg=S.SolverConfig(),
                                      device="cpu", **kw))


def same_trajectory(got, want, pos_tol=POS_TOL, quat_tol=QUAT_TOL):
    (_, p, q), (_, jp, jq) = got[:3], want[:3]
    assert p.shape == jp.shape and q.shape == jq.shape
    assert np.abs(p - jp).max() <= pos_tol, np.abs(p - jp).max()
    # a quaternion and its negation are one rotation
    q = q * np.sign((q * jq).sum(-1, keepdims=True))
    assert np.abs(q - jq).max() <= quat_tol, np.abs(q - jq).max()


def test_build_hulls_equal_jax():
    rng = np.random.default_rng(0)
    sets = [cube(0.3), rng.standard_normal((200, 3)).astype(np.float32)]
    got = SHP.build_hulls(sets, max_faces=48, device="cpu")
    want = JSHP.build_hulls(sets, max_faces=48)
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def terrain():
    """A bumpy 12×12 height field, numpy-seeded: (vertices, faces)."""
    rng = np.random.default_rng(1)
    g = np.linspace(-2, 2, 12)
    x, y = np.meshgrid(g, g)
    z = 0.2 * rng.random(x.shape)
    v = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(144).reshape(12, 12)
    a, b, c, d = (idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:])
    f = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                        np.stack([a, d, c], -1).reshape(-1, 3)])
    return v, f.astype(np.int64)


def test_build_mesh_grid_equal_jax(terrain):
    got = SHP.build_mesh_grid(*terrain, resolution=10, max_per_cell=16,
                              device="cpu")
    want = JSHP.build_mesh_grid(*terrain, resolution=10, max_per_cell=16)
    assert got.dims == want.dims
    for name in ("tri_a", "tri_b", "tri_c", "tri_n", "cell_tris", "origin",
                 "cell_size"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name


def test_mesh_contact_query_matches_jax(terrain):
    import jax.numpy as jnp

    got_g = SHP.build_mesh_grid(*terrain, resolution=10, device="cpu")
    want_g = JSHP.build_mesh_grid(*terrain, resolution=10)
    rng = np.random.default_rng(2)
    pts = (rng.random((600, 3)) * [4.4, 4.4, 0.8] - [2.2, 2.2, 0.2]).astype(
        np.float32)
    got = SHP.mesh_contact_query(got_g, torch.tensor(pts))
    want = JSHP.mesh_contact_query(want_g, jnp.asarray(pts))
    inf_a, inf_b = ~torch.isfinite(got[0]).numpy(), ~np.isfinite(want[0])
    assert np.array_equal(inf_a, inf_b) and not inf_a.all()
    for a, b in zip(got, want):
        a, b = a.numpy()[~inf_b], np.asarray(b)[~inf_b]
        assert np.abs(a - b).max() <= 1e-5
    assert np.array_equal(
        SHP.mesh_closest_triangle(got_g, torch.tensor(pts)).numpy(),
        np.asarray(JSHP.mesh_closest_triangle(want_g, jnp.asarray(pts))))


@pytest.fixture(scope="module")
def drop():
    jw, pw = worlds(DROP, [cube()])
    return JW.simulate(jw, 8, return_impacts=True), pw


def test_bench_drop_matches_jax(drop):
    want, pw = drop
    got = W.simulate(pw, 8, return_impacts=True)
    same_trajectory(got, want)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-3)
    z = got[1][:, 0, 2]
    assert z[-1] < z[0] - 0.3  # it fell
    assert z.min() > 0.3 + 0.3 - 1e-3  # never through the ground


def test_simulate_is_deterministic(drop):
    _, pw = drop
    a, b = W.simulate(pw, 8), W.simulate(pw, 8)
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])


def test_origin_trajectory_and_rb_transform_match_jax(drop):
    import jax.numpy as jnp

    from autovfx_tpu.core.quaternion import quat_to_rotmat

    (jfinal, jpos, jquat, _), pw = drop
    jw, _ = worlds(DROP, [cube()])
    pos, rot = W.origin_trajectory(pw, jpos, jquat)
    want_rot = np.asarray(quat_to_rotmat(jnp.asarray(
        jquat.reshape(-1, 4)))).reshape(8, -1, 3, 3)
    np.testing.assert_allclose(rot, want_rot, rtol=0, atol=1e-6)
    want_pos = jpos - np.einsum("fbij,bj->fbi", want_rot, jw.com_offsets)
    np.testing.assert_allclose(pos, want_pos, rtol=0, atol=1e-6)
    a = W.rb_transform_schema(pw, jpos, jquat)
    b = JW.rb_transform_schema(jw, jpos, jquat)
    assert a.keys() == b.keys()
    for name in a:
        for f in a[name]:
            for k in ("pos", "rot", "scale"):
                np.testing.assert_allclose(a[name][f][k], b[name][f][k],
                                           rtol=0, atol=1e-5)


def run_golden(name):
    d = np.load(os.path.join(G.GOLDEN, f"physics_{name}.npz"))
    objects = [{"pos": d["init_pos"][i].tolist(),
                "rot": G.quat_to_rotmat_np(d["init_quat"][i]),
                "scale": 1.0,
                "rigid_body": {"rb_type": "ACTIVE", "mass": 1.0,
                               "restitution": float(d["restitution"][i])}}
               for i in range(len(d["half"]))]
    verts = [G.cube_corners(h) for h in d["half"]]
    world = W.RigidWorld.from_objects(objects, verts,
                                      scene_vertices=G.GROUND_V,
                                      scene_faces=G.GROUND_F,
                                      cfg=S.SolverConfig(), device="cpu")
    world.state = world.state.replace(
        linvel=torch.tensor(d["init_v"].astype(np.float32)))
    _, pos, quat = W.simulate(world, d["pos"].shape[0])
    return pos, quat, d


class TestTrajectoryGoldens:
    """``tests/test_physics_golden.py``'s bounds, through the port."""

    def test_drop(self):
        pos, _, d = run_golden("drop")
        assert G.max_dev(pos, d["pos"]) < 0.15
        assert G.max_dev(pos[-5:], d["pos"][-5:]) < 0.01

    def test_tumble(self):
        pos, _, d = run_golden("tumble")
        assert G.max_dev(pos, d["pos"]) < 0.25
        assert abs(pos[-1, 0, 2] - d["pos"][-1, 0, 2]) < 0.01
        assert G.max_dev(pos[-5:], d["pos"][-5:]) < 0.2

    def test_stack(self):
        pos, _, d = run_golden("stack")
        assert G.max_dev(pos, d["pos"]) < 0.05
        assert abs(pos[-1, 1, 2] - d["pos"][-1, 1, 2]) < 0.01
        assert G.max_dev(pos[-5:], d["pos"][-5:]) < 0.03


def test_kinematic_pusher_matches_jax():
    """A kinematic slab on a trajectory pushes an active cube."""
    objects = [
        {"pos": [0.0, 0.0, 0.61], "scale": 1.0,
         "rigid_body": {"rb_type": "ACTIVE", "mass": 1.0,
                        "restitution": 0.2}},
        {"pos": [-1.0, 0.0, 0.61], "rot": [0.0, 0.0, 0.3], "scale": 1.0,
         "forward_axis": "FORWARD_X",
         "rigid_body": {"rb_type": "KINEMATIC", "mass": 1.0},
         "animation": {"type": "trajectory",
                       "points": [[-1.0, 0.0, 0.61], [0.2, 0.0, 0.61]]}},
    ]
    frames = 10
    kin = ANIM.kinematic_schedule(objects, frames)
    want_kin = JANIM.kinematic_schedule(objects, frames)
    assert kin.keys() == want_kin.keys() == {1}
    for a, b in zip(kin[1], want_kin[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    jw, pw = worlds(objects, [cube(), cube()])
    same_trajectory(W.simulate(pw, frames, kinematic=kin),
                    JW.simulate(jw, frames, kinematic=want_kin))


def test_enabled_schedule_matches_jax():
    """Physics switched on for the second body after 3 frames."""
    objects = [dict(DROP[0]), dict(DROP[0], pos=[1.2, 0.0, 1.0])]
    sched = np.ones((8, 2), bool)
    sched[:3, 1] = False
    jw, pw = worlds(objects, [cube(), cube(0.2)])
    got = W.simulate(pw, 8, enabled_schedule=sched)
    same_trajectory(got, JW.simulate(jw, 8, enabled_schedule=sched))
    assert np.array_equal(got[1][:3, 1], np.broadcast_to(got[1][0, 1],
                                                          (3, 3)))


@pytest.mark.parametrize("axis", ["TRACK_NEGATIVE_Y", "FORWARD_X"])
def test_animation_matches_jax(axis):
    pts = np.array([[0, 0, 0], [1, 0.5, 0], [1.5, 2.0, 0.2]], np.float64)
    for a, b in zip(ANIM.interpolate_trajectory(pts, 9),
                    JANIM.interpolate_trajectory(pts, 9)):
        assert np.array_equal(a, b)
    tang = ANIM.interpolate_trajectory(pts, 9)[1]
    assert np.array_equal(ANIM.animation_rotation(tang, axis),
                          JANIM.animation_rotation(tang, axis))
