"""Training checkpoints shared by the PyTorch port and the JAX package.

Both write one ``.npz`` with the same key names.  A checkpoint written
by JAX ``save_checkpoint`` must load into the port bit for bit, one
written by the port must load into JAX bit for bit, and
``convert.train_state`` must carry a JAX ``TrainState``'s arrays over
exactly.  The states are taken after two Adam updates, with densify
stats set, so every field holds numbers.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.train import checkpoint as JCk
from autovfx_tpu.train import densify as JD
from autovfx_tpu.train import trainer as JT
from autovfx_tpu.utils.synthetic import make_scene
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.core import ply_io
from autovfx_tpu_torch.train import checkpoint as Ck

PARAMS = ("xyz", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logit")
GAUSS = PARAMS + ("active",)


@pytest.fixture(scope="module")
def jax_state():
    g, _ = make_scene(n=60, width=16, height=16, key=4)
    g = g.pad_to(80)
    s = JT.init_state(g)
    rng = np.random.default_rng(4)
    cfg = JT.TrainConfig()
    gauss, adam = s.gaussians, s.adam
    for step in range(2):
        grads = {f: jnp.asarray(rng.standard_normal(np.shape(getattr(g, f)))
                                .astype(np.float32)) for f in PARAMS}
        gauss, adam = JT.apply_adam(gauss, adam, grads, jnp.int32(step), cfg)
    stats = JD.DensifyStats(
        grad_accum=jnp.asarray(rng.random(80).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 5, 80).astype(np.float32)),
        max_radii=jnp.asarray(rng.integers(0, 30, 80).astype(np.int32)),
    )
    return s.replace(gaussians=gauss, adam=adam, stats=stats,
                     step=jnp.int32(2))


def jax_arrays(s) -> dict:
    out = {}
    for prefix, g in (("g_", s.gaussians), ("m_", s.adam.m), ("v_", s.adam.v)):
        out.update({prefix + f: np.asarray(getattr(g, f)) for f in GAUSS})
    out.update(adam_count=np.asarray(s.adam.count), step=np.asarray(s.step),
               **{"stats_" + f: np.asarray(getattr(s.stats, f))
                  for f in ("grad_accum", "denom", "max_radii")})
    return out


def assert_state_equals_arrays(state, arrays):
    for prefix, g in (("g_", state.gaussians), ("m_", state.adam.m),
                      ("v_", state.adam.v)):
        for f in GAUSS:
            got = getattr(g, f).numpy()
            want = np.asarray(arrays[prefix + f])
            if f == "active":
                want = want.astype(bool)
            assert got.dtype == want.dtype, (prefix, f)
            np.testing.assert_array_equal(got, want, err_msg=prefix + f)
    assert state.adam.count == int(arrays["adam_count"])
    assert state.step == int(arrays["step"])
    for f in ("grad_accum", "denom", "max_radii"):
        got, want = getattr(state.stats, f).numpy(), arrays["stats_" + f]
        assert got.dtype == np.asarray(want).dtype, f
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f)


def test_convert_train_state_is_exact(jax_state):
    arrays = jax_arrays(jax_state)
    assert_state_equals_arrays(convert.train_state(arrays), arrays)


def test_jax_checkpoint_loads_into_the_port(jax_state, tmp_path):
    path = str(tmp_path / "jax.npz")
    JCk.save_checkpoint(path, jax_state)
    assert_state_equals_arrays(Ck.load_checkpoint(path), jax_arrays(jax_state))


def test_port_checkpoint_loads_into_jax(jax_state, tmp_path):
    state = convert.train_state(jax_arrays(jax_state))
    path = str(tmp_path / "port.npz")
    Ck.save_checkpoint(path, state)
    back = JCk.load_checkpoint(path)
    assert_state_equals_arrays(state, jax_arrays(back))
    with np.load(path) as d:
        assert set(d.files) == set(jax_arrays(jax_state))


def test_port_round_trip_and_snapshot(jax_state, tmp_path):
    state = convert.train_state(jax_arrays(jax_state))
    ckpt = Ck.save_snapshot(str(tmp_path / "model"), state, 7000)
    assert os.path.basename(ckpt) == "chkpnt7000.npz"
    assert_state_equals_arrays(Ck.load_checkpoint(ckpt),
                               Ck.state_arrays(state))
    ply = tmp_path / "model" / "point_cloud" / "iteration_7000" / "point_cloud.ply"
    g = ply_io.load_ply(str(ply))
    assert g.capacity == int(state.gaussians.num_active) == 60
    torch.testing.assert_close(g.xyz, state.gaussians.xyz[:60])


def test_train_checkpoints_periodically(tmp_path):
    """``train`` saves the whole state every ``checkpoint_every`` steps
    and at the end; the last file holds the returned state."""
    from autovfx_tpu_torch.core import cameras as C
    from autovfx_tpu_torch.ops.rasterize import RasterConfig
    from autovfx_tpu_torch.train import trainer as T
    from autovfx_tpu_torch.utils.synthetic import make_gaussians

    g = make_gaussians(40, np.random.default_rng(1))
    cams = C.stack_cameras([C.look_at_camera([3.0, 0.5, 1.0], [0, 0, 0],
                                             [0, 0, 1], fx=20.0, fy=20.0,
                                             width=24, height=16)])
    imgs = torch.rand((1, 16, 24, 3), generator=torch.Generator().manual_seed(0))
    cfg = T.TrainConfig(iterations=5, raster=RasterConfig(dup_budget=1 << 12))
    path = str(tmp_path / "ckpt" / "state.npz")
    state, _ = T.train(g, cams, imgs, cfg, checkpoint_path=path,
                       checkpoint_every=2)
    loaded = Ck.load_checkpoint(path)
    assert loaded.step == state.step == 5 and loaded.adam.count == 5
    torch.testing.assert_close(loaded.gaussians.xyz, state.gaussians.xyz,
                               rtol=0, atol=0)
    assert not torch.equal(state.gaussians.xyz, g.xyz)  # it trained
