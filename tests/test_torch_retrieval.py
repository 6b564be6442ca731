"""Asset retrieval in the port against the JAX package, on the CPU: the
embedding index and its builder, the retrieval wrappers, the GPT-4V
offline estimates, the asset previews, ``retrieve_asset`` and the
video helpers.

- the index: hash embeddings bit-equal to JAX's, files readable by
  either package, top-k equal to a brute-force search, the threshold,
  the animated mask, an embedder mismatch, the ``python -m`` builder;
- the wrappers over a local library: the same asset, material and
  vehicle as JAX's after the same ``random.seed`` (token-overlap
  ranking, no CLIP), Meshy mocked as ``tests/test_perception.py`` mocks
  it, ``glb_has_animation``;
- GPT-4V offline: the size table and the default axis equal to JAX's,
  and the port's ``gpt4v`` with ``requests`` unimportable;
- ``render_asset_previews`` at 64² against JAX's (unit view directions,
  ``tests/test_torch_edit.jax_reference``; its recording ``previews``):
  PSNR > 40 dB per view, the fused-frame budget of
  ``tests/test_torch_clip.py``;
- ``retrieve_asset``'s object dict equal to JAX's;
- ``utils/video``: the frame directory written without a video backend,
  and ``render_trajectory`` against JAX's on 2 cameras (PNGs within
  1/255, depth within 1e-4 of its largest).
"""
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_references as REF  # noqa: E402
from test_torch_edit import scenes, write_scene  # noqa: E402
from test_torch_train import port_camera, port_gaussians  # noqa: E402
from autovfx_tpu.core import cameras as JC  # noqa: E402
from autovfx_tpu.edit import edit_utils as JEU  # noqa: E402
from autovfx_tpu.edit import mesh_io as JMIO  # noqa: E402
from autovfx_tpu.ops.rasterize import RasterConfig as JConfig  # noqa: E402
from autovfx_tpu.perception import gpt4v as JG  # noqa: E402
from autovfx_tpu.retrieval import objaverse_index as JOI  # noqa: E402
from autovfx_tpu.retrieval import wrappers as JW  # noqa: E402
from autovfx_tpu.utils import video as JV  # noqa: E402
from autovfx_tpu.utils.synthetic import make_scene  # noqa: E402
from autovfx_tpu_torch.core import cameras as C  # noqa: E402
from autovfx_tpu_torch.edit import edit_utils as EU  # noqa: E402
from autovfx_tpu_torch.ops.rasterize import RasterConfig  # noqa: E402
from autovfx_tpu_torch.perception import gpt4v as G  # noqa: E402
from autovfx_tpu_torch.render import preview as PV  # noqa: E402
from autovfx_tpu_torch.retrieval import objaverse_index as OI  # noqa: E402
from autovfx_tpu_torch.retrieval import wrappers as W  # noqa: E402
from autovfx_tpu_torch.utils import png  # noqa: E402
from autovfx_tpu_torch.utils import video as V  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import icosphere  # noqa: E402

ENTRIES = {
    "uid-basketball": {"name": "orange basketball", "tags": ["ball", "sport"]},
    "uid-chair": {"name": "wooden chair", "tags": ["furniture"]},
    "uid-dragon": {"name": "flying dragon", "animated": True,
                   "gobj_index": "0/12345"},
    "uid-table": {"name": "dining table", "tags": ["furniture", "wood"]},
    "uid-ball2": {"name": "soccer ball", "tags": ["ball"]},
}
LIBRARY = ("basketball", "red_cube", "chair", "beach_ball", "ball_lamp",
           "soccer_ball")


@pytest.fixture()
def offline(monkeypatch, tmp_path):
    """No SBERT, no CLIP, no index, no keys; a local library of
    ``LIBRARY`` meshes (icospheres with a colour gradient)."""
    for mod in (W, JW):
        monkeypatch.setattr(mod, "_sbert", lambda: None)
        monkeypatch.setattr(mod, "_clip", lambda: None)
    for mod in (OI, JOI):
        monkeypatch.setattr(mod, "_sbert_embed", lambda texts: None)
    for key in (OI.INDEX_ENV, "MESHY_API_KEY", "OPENAI_API_KEY",
                W.MATERIAL_DIR_ENV):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("AUTOVFX_CACHE_DIR", str(tmp_path / "cache"))
    lib = tmp_path / "lib"
    lib.mkdir()
    v, f = icosphere()
    colors = np.stack([0.5 + v[:, 2], 0.4 + 0 * v[:, 0], 0.5 - v[:, 2]], 1)
    for name in LIBRARY:
        JMIO.save_obj(str(lib / f"{name}.obj"), JMIO.Mesh(
            vertices=v, faces=f, vertex_colors=colors.astype(np.float32)))
    monkeypatch.setenv(W.ASSET_DIR_ENV, str(lib))
    return lib


# ---- the index ---------------------------------------------------------------


def test_hash_embeddings_are_bit_equal_to_jax():
    texts = ["orange basketball ball sport", "Wooden-Chair 2", "", "a b a"]
    assert np.array_equal(OI._hash_embed(texts), JOI._hash_embed(texts))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_index_files_cross_packages(offline, tmp_path, writer):
    path = str(tmp_path / "idx.npz")
    (OI if writer == "port" else JOI).build_index(ENTRIES, out_path=path,
                                                  embedder="hash")
    a, b = OI.ObjaverseIndex.load(path), JOI.ObjaverseIndex.load(path)
    assert np.array_equal(a.database, b.database)
    assert list(a.uids) == list(b.uids) and a.embedder == b.embedder
    assert np.array_equal(a.animated, b.animated)
    assert a.gobj_paths(["uid-dragon"]) == {"uid-dragon": "0/12345"}
    with np.load(path, allow_pickle=False) as z:
        assert "database" in z.files


def test_search_is_exact_with_threshold_and_animated_mask(offline):
    idx = OI.build_index(ENTRIES, embedder="hash")
    q = "orange basketball ball"
    sims = idx.database @ OI._hash_embed([q])[0]
    uids, dists = idx.search(q, top_k=3, cosine_threshold=-1.0)
    want = np.argsort(-sims, kind="stable")[:3]
    assert uids == [str(idx.uids[i]) for i in want]
    np.testing.assert_allclose(dists, sims[want], rtol=1e-6)
    assert (uids, dists) == JOI.build_index(ENTRIES, embedder="hash").search(
        q, top_k=3, cosine_threshold=-1.0)
    hi, _ = idx.search(q, top_k=5, cosine_threshold=0.6)
    assert all(sims[list(idx.uids).index(u)] >= 0.6 for u in hi)
    assert len(hi) < 5
    assert idx.search("flying dragon", animated_only=True,
                      cosine_threshold=0.0)[0] == ["uid-dragon"]
    # an index built with SBERT, queried where only the hash embedder is
    bad = OI.ObjaverseIndex(database=idx.database, uids=idx.uids,
                            embedder="sbert:all-mpnet-base-v2")
    with pytest.raises(RuntimeError, match="SBERT|embedder"):
        bad.search(q)


def test_downloads_are_a_noop_offline(offline, tmp_path, monkeypatch):
    monkeypatch.delenv(OI.MIRROR_ENV, raising=False)
    monkeypatch.delenv("AUTOVFX_ALLOW_HUB_DOWNLOAD", raising=False)
    monkeypatch.setitem(sys.modules, "objaverse", None)
    assert OI.download_objects(["uid-x"], str(tmp_path / "dl")) == {}
    assert OI.download_gobjaverse_previews({"uid-x": "0/1"},
                                           str(tmp_path / "pv")) == {}


def test_python_m_builder(offline, tmp_path):
    out = tmp_path / "idx.npz"
    r = subprocess.run(
        [sys.executable, "-m", "autovfx_tpu_torch.retrieval.build_index",
         "--scan-dir", str(offline), "--out", str(out), "--embedder", "hash"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert sorted(OI.ObjaverseIndex.load(str(out)).uids) == sorted(LIBRARY)


# ---- the wrappers ---------------------------------------------------------------


@pytest.mark.parametrize("query", ["ball", "basketball", "red cube"])
def test_same_pick_as_jax_after_the_same_seed(offline, query):
    for seed in range(4):
        random.seed(seed)
        got = W.retrieve_asset_from_objaverse(query)
        random.seed(seed)
        assert got == JW.retrieve_asset_from_objaverse(query)


def test_index_path_resolves_through_a_mirror(offline, tmp_path,
                                              monkeypatch):
    path = str(tmp_path / "idx.npz")
    OI.build_index(ENTRIES, out_path=path, embedder="hash")
    monkeypatch.setenv(OI.INDEX_ENV, path)
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    for uid in ENTRIES:
        (mirror / f"{uid}.glb").write_bytes(b"glb")
    monkeypatch.setenv(OI.MIRROR_ENV, str(mirror))
    for seed in range(3):
        random.seed(seed)
        got = W.retrieve_asset_from_objaverse("orange basketball ball sport")
        random.seed(seed)
        want = JW.retrieve_asset_from_objaverse("orange basketball ball sport")
        assert got["object_id"] == want["object_id"] == "uid-basketball"


def test_meshy_workflow_mocked(offline, tmp_path, monkeypatch):
    import urllib.request

    calls = []

    def fake_request(url, api_key, payload=None):
        calls.append(payload)
        if payload is not None:
            return {"result": "task-" + payload["mode"]}
        return {"status": "SUCCEEDED",
                "model_urls": {"glb": "https://x/model.glb"}}

    monkeypatch.setenv("MESHY_API_KEY", "k")
    monkeypatch.setattr(W, "_meshy_request", fake_request)
    monkeypatch.setattr(urllib.request, "urlretrieve",
                        lambda url, path: open(path, "wb").close())
    out = W.retrieve_asset_from_meshy("red dragon", out_dir=str(tmp_path))
    assert out["source"] == "meshy"
    assert out["object_path"] == str(tmp_path / "red_dragon.glb")
    assert [p["mode"] for p in calls if p] == ["preview", "refine"]
    monkeypatch.delenv("MESHY_API_KEY")
    random.seed(1)
    got = W.retrieve_asset_from_meshy("basketball")
    random.seed(1)
    assert got == JW.retrieve_asset_from_meshy("basketball")


def test_polyhaven_and_chatsim_match_jax(offline, tmp_path, monkeypatch):
    mats = tmp_path / "materials"
    for name in ("oak_wood", "dark_wood", "red_brick", "marble_01"):
        (mats / name).mkdir(parents=True)
    assert W.retrieve_materials_from_polyhaven("wood") is None
    monkeypatch.setenv(W.MATERIAL_DIR_ENV, str(mats))
    for seed in range(4):
        random.seed(seed)
        got = W.retrieve_materials_from_polyhaven("wood")
        random.seed(seed)
        assert got == JW.retrieve_materials_from_polyhaven("wood")
    # without the vehicle bank the generic library answers
    random.seed(0)
    got = W.retrieve_chatsim_vehicle("police car")
    random.seed(0)
    assert got == JW.retrieve_chatsim_vehicle("police car")
    (offline / "chatsim").mkdir()
    (offline / "chatsim" / "police_car.glb").write_bytes(b"glb")
    got = W.retrieve_chatsim_vehicle("police car")
    assert got == JW.retrieve_chatsim_vehicle("police car")
    assert got["object_id"] == "police_car"


def test_glb_animation_matches_jax(tmp_path):
    import struct

    def write_glb(path, gltf):
        data = json.dumps(gltf).encode()
        data += b" " * ((-len(data)) % 4)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, 20 + len(data)))
            f.write(struct.pack("<II", len(data), 0x4E4F534A))
            f.write(data)

    anim, static = str(tmp_path / "a.glb"), str(tmp_path / "s.glb")
    write_glb(anim, {"asset": {"version": "2.0"},
                     "animations": [{"channels": []}]})
    write_glb(static, {"asset": {"version": "2.0"}})
    (tmp_path / "g.gltf").write_text(json.dumps({"animations": [1]}))
    for p in (anim, static, str(tmp_path / "g.gltf"), "none.obj"):
        assert W.glb_has_animation(p) == JW.glb_has_animation(p)
    assert W.glb_has_animation(anim) and not W.glb_has_animation(static)


# ---- GPT-4V offline --------------------------------------------------------------


def test_gpt4v_offline_matches_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    for name in ("basketball", "Tennis Ball", "a red sofa", "spaceship",
                 None, "old table lamp"):
        assert G.estimate_object_scale(None, name) == \
            JG.estimate_object_scale(None, name)
    assert G.estimate_object_scale(None, "basketball") == 0.24
    assert G.estimate_object_forward_axis(str(tmp_path), "car") == \
        JG.estimate_object_forward_axis(str(tmp_path), "car") == \
        "TRACK_NEGATIVE_Y"


def test_gpt4v_answers_without_requests():
    code = ("import sys\nsys.modules['requests'] = None\n"
            "import os\nos.environ.pop('OPENAI_API_KEY', None)\n"
            "from autovfx_tpu_torch.perception import gpt4v\n"
            "print(gpt4v.estimate_object_scale(None, 'basketball'))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "0.24", r.stderr


# ---- previews and retrieve_asset ---------------------------------------------


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def preview_inputs(root: str):
    """The basketball (an icosphere with a colour gradient) written to
    ``root``: its path and the digest of the previews' inputs."""
    v, f = icosphere()
    obj = os.path.join(root, "basketball.obj")
    colors = np.stack([0.5 + v[:, 2], 0.4 + 0 * v[:, 0], 0.5 - v[:, 2]], 1)
    JMIO.save_obj(obj, JMIO.Mesh(vertices=v, faces=f,
                                 vertex_colors=colors.astype(np.float32)))
    return obj, REF.digest(dict(
        files=REF.file_digests(root, ["basketball.obj"]), size=64))


@pytest.fixture(scope="module")
def previews(tmp_path_factory):
    """The basketball's 64² previews rendered by the port, and JAX's as
    its recording ``previews`` holds them (each PNG as PIL reads it)."""
    root = tmp_path_factory.mktemp("previews")
    obj, key = preview_inputs(str(root))
    got = PV.render_asset_previews(obj, str(root / "port"), "basketball",
                                   size=64, device="cpu")
    return got, REF.load("previews", key)


def test_previews_match_jax(previews):
    got, want = previews
    names = sorted(want)
    assert sorted(os.listdir(got)) == names == [f"{i:03d}.png"
                                                for i in range(4)]
    for name in names:
        a = png.read_png(os.path.join(got, name))
        b = want[name]
        assert a.shape == b.shape == (64, 64, 3)
        assert (a.min(-1) < 250).sum() > 200  # the ball is in view
        assert psnr(a, b) > 40.0, name


def test_retrieve_asset_matches_jax(previews, offline, tmp_path):
    import shutil

    params = write_scene(str(tmp_path), n_cams=2)
    js, ts = scenes(str(tmp_path), params, scene_scale=2.0)
    for scene in (js, ts):  # the previews exist: neither renders again
        shutil.copytree(previews[0], os.path.join(
            scene.cache_dir, "assets_rendering_multi_views", "basketball"))
    random.seed(3)
    got = EU.retrieve_asset(ts, "basketball")
    random.seed(3)
    want = JEU.retrieve_asset(js, "basketball")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v) if isinstance(v, np.ndarray) \
            else got[k] == v, k
    assert got["object_id"] == "basketball" and got["scale"] == 0.12
    assert got["object_path"] == str(offline / "basketball.obj")


# ---- video -----------------------------------------------------------------------


def test_write_video_without_a_backend_writes_frames(tmp_path, monkeypatch):
    from PIL import Image

    frames = np.random.default_rng(0).random((3, 8, 12, 3)).astype(np.float32)
    V.write_video(frames, str(tmp_path / "port" / "clip.mp4"))
    JV.write_video(frames, str(tmp_path / "jax" / "clip.mp4"))
    for i in range(3):
        a = png.read_png(str(tmp_path / "port" / "clip.mp4.frames"
                             / f"{i:04d}.png"))
        b = np.asarray(Image.open(tmp_path / "jax" / "clip.mp4.frames"
                                  / f"{i:04d}.png"))
        assert np.array_equal(a, b)
    monkeypatch.setitem(sys.modules, "imageio", None)
    V.write_video(frames, str(tmp_path / "none" / "clip.mp4"))
    assert len(os.listdir(tmp_path / "none" / "clip.mp4.frames")) == 3


def test_render_trajectory_matches_jax(tmp_path):
    from PIL import Image

    g, cam = make_scene(n=500, width=48, height=32, key=9)
    cam2 = JC.look_at_camera([3.0, 1.0, 1.5], [0, 0, 0], [0, 0, 1], fx=40.0,
                             fy=40.0, width=48, height=32)
    cams = JC.stack_cameras([cam, cam2])
    want = JV.render_trajectory(g, cams, str(tmp_path / "jax"),
                                config=JConfig(dup_budget=1 << 14,
                                               backend="ref"),
                                save_normal=True)
    pcams = C.stack_cameras([port_camera(c) for c in (cam, cam2)])
    got = V.render_trajectory(port_gaussians(g), pcams, str(tmp_path / "port"),
                              config=RasterConfig(dup_budget=1 << 14),
                              save_normal=True, device="cpu")
    assert got.shape == np.asarray(want).shape == (2, 32, 48, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    for i in range(2):
        for name in (f"{i:05d}.png", f"normal_{i:05d}.png"):
            a = png.read_png(str(tmp_path / "port" / "images" / name))
            b = np.asarray(Image.open(tmp_path / "jax" / "images" / name))
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
        d = [np.load(tmp_path / k / "depth" / f"{i:05d}.npy")
             for k in ("port", "jax")]
        assert np.abs(d[0] - d[1]).max() <= 1e-4 * np.abs(d[1]).max()
