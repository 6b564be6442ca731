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
        {f: np.asarray(getattr(g, f)) for f in convert.GAUSSIAN_FIELDS}
    )


def carry_cam(cam):
    return convert.camera(
        {f: np.asarray(getattr(cam, f)) if f not in ("width", "height")
         else getattr(cam, f) for f in convert.CAMERA_FIELDS}
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
        ct = C.look_at_camera([2.6, 0.3, 1.4], [0, 0, 0.2], [0, 0, 1], **kw)
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
        ct = C.camera_from_c2w(c2w, 100.0, 101.0, 60.0, 40.0, 120, 80)
        close(ct.R, cj.R, rtol=0, atol=0)
        close(ct.t, cj.t, rtol=0, atol=0)

    def test_stack_and_index(self):
        eyes = [[2.0, 0.0, 1.0], [0.0, 2.0, 1.0], [-2.0, 0.0, 1.0]]
        kw = dict(fx=50.0, fy=50.0, width=64, height=48)
        cams_j = JC.stack_cameras(
            [JC.look_at_camera(e, [0, 0, 0], [0, 0, 1], **kw) for e in eyes]
        )
        cams_t = C.stack_cameras(
            [C.look_at_camera(e, [0, 0, 0], [0, 0, 1], **kw) for e in eyes]
        )
        close(cams_t.R, cams_j.R, rtol=0, atol=0)
        one_t, one_j = C.index_camera(cams_t, 1), JC.index_camera(cams_j, 1)
        close(one_t.center, one_j.center)
        assert one_t.width == 64
        with pytest.raises(ValueError):
            C.stack_cameras([C.look_at_camera(eyes[0], [0, 0, 0], [0, 0, 1],
                                              fx=50.0, fy=50.0, width=32,
                                              height=48),
                             C.look_at_camera(eyes[1], [0, 0, 0], [0, 0, 1],
                                              **kw)])


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
        back_t = P.load_ply(str(pj))
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
            P.load_ply(str(p))


class TestConvertAndSynthetic:
    def test_convert_rejects_missing_field(self):
        with pytest.raises(ValueError):
            convert.gaussians(xyz=np.zeros((1, 3)))

    def test_garden_like_shapes_and_seed(self):
        a = S.make_garden_like(3000, seed=1, extent=2.67)
        b = S.make_garden_like(3000, seed=1, extent=2.67)
        assert a.capacity == 3000 and a.sh_degree == 3
        assert torch.equal(a.xyz, b.xyz)
        ground = a.xyz[: 1500, 2]
        assert float(ground.abs().max()) < 0.2  # the flattened disc
        cam = S.garden_camera(648, 420)
        assert (cam.width, cam.height) == (648, 420)
        close(cam.fx, 960.98 / 2)
