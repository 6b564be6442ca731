"""Core of the PyTorch port vs the JAX package, on the CPU.

Inputs come from a seeded numpy generator and go to both packages; the
port is held to rtol 1e-5 / atol 1e-6 (float32 rounding of the same
formulas, evaluated in another order).  PLY files must be byte-equal in
both directions.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from autovfx_tpu.core import cameras as JC
from autovfx_tpu.core import gaussians as JG
from autovfx_tpu.core import ply_io as JP
from autovfx_tpu.core import quaternion as JQ
from autovfx_tpu.core import sh as JSH
from autovfx_tpu.utils import synthetic as JS
from autovfx_tpu_torch import convert
from autovfx_tpu_torch.core import cameras as C
from autovfx_tpu_torch.core import gaussians as G
from autovfx_tpu_torch.core import ply_io as P
from autovfx_tpu_torch.core import quaternion as Q
from autovfx_tpu_torch.core import sh as SH
from autovfx_tpu_torch.utils import synthetic as S

RTOL, ATOL = 1e-5, 1e-6


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        port.detach().cpu().numpy(), np.asarray(ref), rtol=rtol, atol=atol
    )


def carry(g):
    """JAX Gaussians -> port Gaussians through convert's array boundary."""
    return convert.gaussians(
        {f: np.asarray(getattr(g, f)) for f in convert.GAUSSIAN_FIELDS},
        device="cpu",
    )


def carry_cam(cam):
    return convert.camera(
        {f: np.asarray(getattr(cam, f)) if f not in ("width", "height")
         else getattr(cam, f) for f in convert.CAMERA_FIELDS},
        device="cpu",
    )


@pytest.fixture
def rng():
    return np.random.default_rng(7)


class TestQuaternion:
    def test_normalize_and_rotmat(self, rng):
        q = rng.standard_normal((257, 4)).astype(np.float32)
        close(Q.quat_normalize(torch.from_numpy(q)), JQ.quat_normalize(q))
        close(Q.quat_to_rotmat(torch.from_numpy(q)), JQ.quat_to_rotmat(q))

    def test_rotmat_to_quat(self, rng):
        q = rng.standard_normal((257, 4)).astype(np.float32)
        m = np.asarray(JQ.quat_to_rotmat(q))
        close(Q.rotmat_to_quat(torch.tensor(m)), JQ.rotmat_to_quat(m),
              atol=1e-5)


class TestSH:
    @pytest.mark.parametrize("degree", [0, 1, 2, 3])
    def test_eval_and_rgb(self, rng, degree):
        sh = rng.standard_normal((300, 16, 3)).astype(np.float32)
        d = rng.standard_normal((300, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        ts, td = torch.from_numpy(sh), torch.from_numpy(d)
        close(SH.eval_sh(degree, ts, td), JSH.eval_sh(degree, sh, d))
        close(SH.sh_to_rgb(degree, ts, td), JSH.sh_to_rgb(degree, sh, d))

    def test_rgb_to_sh(self, rng):
        rgb = rng.random((64, 3)).astype(np.float32)
        close(SH.rgb_to_sh(torch.from_numpy(rgb)), JSH.rgb_to_sh(rgb))


class TestGaussians:
    def _pair(self, n=400, sh_degree=3):
        import jax

        g = JS.make_gaussians(n, jax.random.PRNGKey(3), sh_degree=sh_degree)
        g = g.replace(active=jnp.arange(n) % 5 != 0)
        return g, carry(g)

    def test_activations(self):
        gj, gt = self._pair()
        assert gt.capacity == gj.capacity and gt.sh_degree == gj.sh_degree
        close(gt.scales, gj.scales)
        close(gt.opacity, gj.opacity)
        close(gt.rotations, gj.rotations)
        close(gt.sh, gj.sh)

    @pytest.mark.parametrize("degree", [None, 0, 1, 2])
    def test_colors(self, degree):
        gj, gt = self._pair()
        campos = np.array([2.0, -1.0, 0.5], np.float32)
        close(gt.colors(torch.from_numpy(campos), degree=degree),
              gj.colors(jnp.asarray(campos), degree=degree))

    def test_colors_cap_at_degree_three(self):
        gj, gt = self._pair(sh_degree=4)
        campos = np.array([2.0, -1.0, 0.5], np.float32)
        assert gt.sh_degree == 4
        close(gt.colors(torch.from_numpy(campos)),
              gj.colors(jnp.asarray(campos)))

    def test_normals(self):
        gj, gt = self._pair()
        d = np.asarray(gj.xyz) - np.array([3.0, 0.0, 1.0], np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        close(gt.normals(torch.from_numpy(d)), gj.normals(jnp.asarray(d)))

    def test_merge_pads_lower_degree(self):
        import jax

        a = JS.make_gaussians(30, jax.random.PRNGKey(0), sh_degree=1)
        b = JS.make_gaussians(20, jax.random.PRNGKey(1), sh_degree=3)
        m_port = G.merge(carry(a), carry(b))
        m_ref = JG.merge(a, b)
        for f in convert.GAUSSIAN_FIELDS:
            close(getattr(m_port, f), getattr(m_ref, f), rtol=0, atol=0)


class TestCameras:
    def test_look_at_and_derived(self):
        kw = dict(fx=96.0, fy=90.0, width=128, height=96)
        cj = JC.look_at_camera([2.6, 0.3, 1.4], [0, 0, 0.2], [0, 0, 1], **kw)
        ct = C.look_at_camera([2.6, 0.3, 1.4], [0, 0, 0.2], [0, 0, 1], **kw,
                              device="cpu")
        for f in ("R", "t", "fx", "fy", "cx", "cy"):
            close(getattr(ct, f), getattr(cj, f), rtol=0, atol=0)
        assert (ct.width, ct.height) == (cj.width, cj.height)
        close(ct.center, cj.center)
        close(ct.tan_half_fovx, cj.tan_half_fovx)
        close(ct.tan_half_fovy, cj.tan_half_fovy)
        # and through the array boundary
        close(carry_cam(cj).center, cj.center)

    def test_camera_from_c2w(self, rng):
        c2w = np.eye(4)
        c2w[:3, :3] = np.asarray(
            JQ.quat_to_rotmat(rng.standard_normal(4).astype(np.float32))
        )
        c2w[:3, 3] = rng.standard_normal(3)
        cj = JC.camera_from_c2w(c2w, 100.0, 101.0, 60.0, 40.0, 120, 80)
        ct = C.camera_from_c2w(c2w, 100.0, 101.0, 60.0, 40.0, 120, 80,
                               device="cpu")
        close(ct.R, cj.R, rtol=0, atol=0)
        close(ct.t, cj.t, rtol=0, atol=0)

    def test_stack_and_index(self):
        eyes = [[2.0, 0.0, 1.0], [0.0, 2.0, 1.0], [-2.0, 0.0, 1.0]]
        kw = dict(fx=50.0, fy=50.0, width=64, height=48)
        cams_j = JC.stack_cameras(
            [JC.look_at_camera(e, [0, 0, 0], [0, 0, 1], **kw) for e in eyes]
        )
        cams_t = C.stack_cameras(
            [C.look_at_camera(e, [0, 0, 0], [0, 0, 1], **kw, device="cpu")
             for e in eyes]
        )
        close(cams_t.R, cams_j.R, rtol=0, atol=0)
        one_t, one_j = C.index_camera(cams_t, 1), JC.index_camera(cams_j, 1)
        close(one_t.center, one_j.center)
        assert one_t.width == 64
        with pytest.raises(ValueError):
            C.stack_cameras([C.look_at_camera(eyes[0], [0, 0, 0], [0, 0, 1],
                                              fx=50.0, fy=50.0, width=32,
                                              height=48, device="cpu"),
                             C.look_at_camera(eyes[1], [0, 0, 0], [0, 0, 1],
                                              **kw, device="cpu")])


class TestPly:
    def test_bytes_equal_both_directions(self, tmp_path):
        import jax

        gj = JS.make_gaussians(123, jax.random.PRNGKey(5))
        gj = gj.replace(active=jnp.arange(123) % 7 != 0)
        gt = carry(gj)
        pj, pt = tmp_path / "jax.ply", tmp_path / "port.ply"
        JP.save_ply(str(pj), gj)
        P.save_ply(str(pt), gt)
        assert pj.read_bytes() == pt.read_bytes()

        # reverse: each package reads the other's file and writes it back
        back_t = P.load_ply(str(pj), device="cpu")
        back_j = JP.load_ply(str(pt))
        P.save_ply(str(tmp_path / "t2.ply"), back_t)
        JP.save_ply(str(tmp_path / "j2.ply"), back_j)
        assert (tmp_path / "t2.ply").read_bytes() == pj.read_bytes()
        assert (tmp_path / "j2.ply").read_bytes() == pj.read_bytes()
        for f in convert.GAUSSIAN_FIELDS:
            close(getattr(back_t, f), getattr(back_j, f), rtol=0, atol=0)

    def test_rejects_ascii(self, tmp_path):
        p = tmp_path / "a.ply"
        p.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 0\nend_header\n")
        with pytest.raises(ValueError):
            P.load_ply(str(p), device="cpu")


class TestConvertAndSynthetic:
    def test_convert_rejects_missing_field(self):
        with pytest.raises(ValueError):
            convert.gaussians(xyz=np.zeros((1, 3)), device="cpu")

    def test_garden_like_shapes_and_seed(self):
        a = S.make_garden_like(3000, seed=1, extent=2.67, device="cpu")
        b = S.make_garden_like(3000, seed=1, extent=2.67, device="cpu")
        assert a.capacity == 3000 and a.sh_degree == 3
        assert torch.equal(a.xyz, b.xyz)
        ground = a.xyz[: 1500, 2]
        assert float(ground.abs().max()) < 0.2  # the flattened disc
        cam = S.garden_camera(648, 420, device="cpu")
        assert (cam.width, cam.height) == (648, 420)
        close(cam.fx, 960.98 / 2)


# ---- the edited frame's additions (quaternion algebra, camera matrices) -------


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quaternion_algebra_matches_jax():
    rng = np.random.default_rng(20)
    a, b = _quats(rng, 50), _quats(rng, 50)
    v = rng.standard_normal((50, 3)).astype(np.float32)
    axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
    ang = rng.uniform(-3, 3, 50).astype(np.float32)
    t = torch.tensor
    pairs = [
        (Q.quat_multiply(t(a), t(b)), JQ.quat_multiply(jnp.asarray(a),
                                                       jnp.asarray(b))),
        (Q.quat_rotate(t(a), t(v)), JQ.quat_rotate(jnp.asarray(a),
                                                   jnp.asarray(v))),
        (Q.quat_conjugate(t(a)), JQ.quat_conjugate(jnp.asarray(a))),
        (Q.quat_from_axis_angle(t(axis), t(ang)),
         JQ.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(ang))),
        (Q.quat_integrate(t(a), t(v), 1.0 / 60.0),
         JQ.quat_integrate(jnp.asarray(a), jnp.asarray(v), 1.0 / 60.0)),
        (Q.euler_to_rotmat(0.3, -1.1, 2.0),
         JQ.euler_to_rotmat(jnp.float32(0.3), jnp.float32(-1.1),
                            jnp.float32(2.0))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)


def test_camera_matrices_match_jax():
    kw = dict(fx=70.0, fy=72.0, width=97, height=63)
    cam = C.look_at_camera([2.0, -1.0, 1.5], [0, 0, 0.2], [0, 0, 1],
                           device="cpu", **kw)
    jcam = JC.look_at_camera([2.0, -1.0, 1.5], [0, 0, 0.2], [0, 0, 1], **kw)
    for name in ("c2w", "w2c", "K"):
        np.testing.assert_allclose(getattr(cam, name).numpy(),
                                   np.asarray(getattr(jcam, name)), rtol=0,
                                   atol=1e-6)
    pts = np.random.default_rng(21).standard_normal((40, 3)).astype(
        np.float32)
    (uv, z), (juv, jz) = cam.project(torch.tensor(pts)), jcam.project(
        jnp.asarray(pts))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-6)
    for factor in (2, 3):
        small, jsmall = cam.resized(factor), jcam.resized(factor)
        assert (small.width, small.height) == (jsmall.width, jsmall.height)
        for f in ("fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(getattr(small, f).numpy(),
                                       np.asarray(getattr(jsmall, f)),
                                       rtol=1e-7)
    batch = C.stack_cameras([cam, cam])
    assert batch.c2w.shape == (2, 4, 4) and batch.K.shape == (2, 3, 3)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_num_sh_coeffs_matches_jax(degree):
    assert SH.num_sh_coeffs(degree) == JSH.num_sh_coeffs(degree)


def test_sh_from_rgb_matches_jax():
    rgb = np.random.default_rng(3).random((50, 3), dtype=np.float32)
    got = SH.sh_from_rgb(torch.tensor(rgb))
    close(got, JSH.sh_from_rgb(jnp.asarray(rgb)))
    assert torch.equal(got, SH.rgb_to_sh(torch.tensor(rgb)))


@pytest.mark.parametrize("kw", [{}, {"fx": 30.0, "cam_dist": 3.0}])
def test_make_scene_matches_jax(kw):
    """The camera equals JAX's within 1e-6; the Gaussians (numpy's draws,
    not JAX's) have JAX's shapes, dtypes and value ranges."""
    g, cam = S.make_scene(n=300, width=40, height=30, seed=2, device="cpu",
                          **kw)
    jg, jcam = JS.make_scene(n=300, width=40, height=30, key=2, **kw)
    assert (cam.width, cam.height) == (jcam.width, jcam.height)
    for f in convert.CAMERA_FIELDS:
        if f not in ("width", "height"):
            close(getattr(cam, f), getattr(jcam, f), rtol=0, atol=1e-6)
    for f in convert.GAUSSIAN_FIELDS:
        a, b = getattr(g, f).numpy(), np.asarray(getattr(jg, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
    assert bool(g.active.all())
    rgb = g.sh_dc.numpy() * SH.C0 + 0.5
    assert rgb.min() >= -1e-6 and rgb.max() <= 1 + 1e-6
    scales = np.exp(g.log_scales.numpy())
    assert scales.min() >= 0.01 - 1e-7 and scales.max() <= 0.08 + 1e-7
    op = torch.sigmoid(g.opacity_logit).numpy()
    assert op.min() >= 0.2 - 1e-6 and op.max() <= 0.95 + 1e-6
    np.testing.assert_allclose(np.linalg.norm(g.quats.numpy(), axis=-1), 1.0,
                               atol=1e-6)
    assert np.abs(g.sh_rest.numpy()).max() < 0.05 * 6


@pytest.mark.parametrize("pkg,module", [
    ("core", None), ("ops", "rasterize"), ("physics", "world")])
def test_subpackage_reexports_match_jax(pkg, module):
    """The same ``__all__`` as the JAX package's, each name the very
    object of the submodule that defines it."""
    import importlib

    port = importlib.import_module("autovfx_tpu_torch." + pkg)
    ref = importlib.import_module("autovfx_tpu." + pkg)
    assert port.__all__ == ref.__all__
    homes = ({"Gaussians": G, "Camera": C} if module is None else
             dict.fromkeys(port.__all__, importlib.import_module(
                 f"autovfx_tpu_torch.{pkg}.{module}")))
    for name in port.__all__:
        assert getattr(port, name) is getattr(homes[name], name), name


def test_rasterize_reexport_shadows_the_submodule_as_in_jax():
    """``ops.rasterize`` is the re-exported function, in both packages, so
    ``import autovfx_tpu_torch.ops.rasterize as R`` binds the function,
    not the module: code that needs the module's other names imports them
    from it (``from autovfx_tpu_torch.ops.rasterize import ...``), and no
    module of the port, test of it or ``chip_smoke.py`` takes the alias."""
    import importlib
    import pathlib
    import re
    import sys

    import autovfx_tpu.ops.rasterize as JR  # noqa: F401
    import autovfx_tpu_torch.ops.rasterize as R
    from autovfx_tpu_torch.ops.rasterize import (RasterConfig,
                                                 preprocess_sets, rasterize,
                                                 rasterize_multi, render)

    module = sys.modules["autovfx_tpu_torch.ops.rasterize"]
    assert R is rasterize is module.rasterize
    assert JR is sys.modules["autovfx_tpu.ops.rasterize"].rasterize
    assert importlib.import_module("autovfx_tpu_torch.ops.rasterize") is module
    for f in (RasterConfig, preprocess_sets, rasterize_multi, render):
        assert getattr(module, f.__name__) is f
    root = pathlib.Path(__file__).resolve().parents[1]
    alias = re.compile(r"import autovfx_tpu_torch\.ops\.rasterize as|"
                       r"from autovfx_tpu_torch\.ops import [^\n]*\brasterize"
                       r" as")
    files = [*(root / "autovfx_tpu_torch").rglob("*.py"),
             root / "chip_smoke.py", *(root / "tests").glob("test_torch_*.py")]
    takers = [str(p.relative_to(root)) for p in files
              if p != pathlib.Path(__file__).resolve()
              and alias.search(p.read_text())]
    assert not takers, takers
