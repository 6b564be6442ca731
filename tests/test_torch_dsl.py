"""The port's edit DSL, program runner and CLI against the JAX package's.

- every worked query of both planner prompts runs through the port's DSL
  and ``exec_safe``, with ``tests/test_prompt_exemplars.py``'s stubs
  rebuilt over the port's ``edit_utils``, and leaves the same objects,
  events, fire and smoke lists as the JAX DSL under the same seeds;
- every name ``setup_LMP`` binds has the JAX function's signature;
- ``exec_safe``'s guards, ``tests/test_edit.py``'s offline program, the
  LLM disk cache across packages, the prompts shipped with the port;
- the port's CLI (``python -m autovfx_tpu_torch.edit_scene --device
  cpu``) writes its frames and edit config.
"""
import inspect
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import test_prompt_exemplars as TPE  # noqa: E402
from autovfx_tpu.edit.edit_ir import _to_jsonable  # noqa: E402
from autovfx_tpu.edit.edit_ir import (  # noqa: E402
    default_object_info as J_default_object_info,
)
from autovfx_tpu.gpt import cache as JCACHE  # noqa: E402
from autovfx_tpu.gpt import lmp as JLMP  # noqa: E402
from autovfx_tpu_torch.edit import edit_ir as IR  # noqa: E402
from autovfx_tpu_torch.edit import edit_utils as EU  # noqa: E402
from autovfx_tpu_torch.gpt import cache as CACHE  # noqa: E402
from autovfx_tpu_torch.gpt import lmp as LMP  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = os.path.join(os.path.dirname(LMP.__file__), "prompts")
DEFAULT = TPE.parse_exemplars(os.path.join(PROMPTS, "planner_prompt.txt"))
WAYMO = TPE.parse_exemplars(os.path.join(PROMPTS,
                                         "planner_prompt_waymo.txt"))


def _port_object(name):
    """``test_prompt_exemplars._fake_object`` from the port's schema (the
    same unit-box asset file and id)."""
    ref = TPE._fake_object(name)
    obj = IR.default_object_info()
    for k in ("object_name", "object_id", "object_path", "pos", "scale"):
        obj[k] = ref[k]
    return obj


def port_dsl_vars(scene):
    """``test_prompt_exemplars.build_dsl_vars`` over the port's DSL: its
    pure functions and signature-checked stubs of its own perception,
    retrieval and camera functions."""
    pure = ["insert_object", "allow_physics", "add_fire", "add_smoke",
            "set_static_animation", "set_moving_animation", "init_material",
            "apply_material", "allow_fracture", "get_object_bottom_position",
            "get_object_center_position", "translate_object",
            "rotate_object", "scale_object", "get_random_2D_rotation",
            "get_random_3D_rotation", "make_copy", "make_break",
            "make_melting", "add_event"]
    g = {n: getattr(EU, n) for n in pure}
    stub = TPE._stub
    g["get_camera_position"] = stub(
        EU.get_camera_position, lambda s: np.array([0, -3, 1.5], np.float32))
    g["get_vehicle_position"] = stub(
        EU.get_vehicle_position, lambda s: np.zeros(3, np.float32))
    g["get_direction"] = stub(
        EU.get_direction,
        lambda s, direction="front": {
            "front": np.array([0, 1, 0]), "back": np.array([0, -1, 0]),
            "left": np.array([-1, 0, 0]), "right": np.array([1, 0, 0]),
            "up": np.array([0, 0, 1]), "down": np.array([0, 0, -1]),
        }[direction].astype(np.float32))
    g["detect_object"] = stub(EU.detect_object,
                              lambda s, name: _port_object(name))
    g["sample_point_on_object"] = stub(
        EU.sample_point_on_object,
        lambda s, o: np.array([0.1, 0.2, 0.8], np.float32))
    g["sample_point_above_object"] = stub(
        EU.sample_point_above_object,
        lambda s, o, VERTICAL_OFFSET=0.6: np.array([0.1, 0.2, 1.4],
                                                   np.float32))
    g["retrieve_asset"] = stub(
        EU.retrieve_asset,
        lambda s, name, is_animated=False, is_generated=False:
            _port_object(name))
    g["retrieve_chatsim_asset"] = stub(EU.retrieve_chatsim_asset,
                                       lambda s, name: _port_object(name))
    g["retrieve_material"] = stub(EU.retrieve_material,
                                  lambda s, name: f"/materials/{name}")
    g["remove_object"] = stub(
        EU.remove_object,
        lambda s, o, remove_gaussians=True: s.inserted_objects.append(
            {"removed": o["object_id"]}))
    g["update_object"] = stub(EU.update_object,
                              lambda s, o: s.inserted_objects.append(o))
    g["scene"] = scene
    g["np"] = np
    return g


def _state(scene) -> str:
    return json.dumps(_to_jsonable({
        "objects": scene.inserted_objects, "events": scene.events,
        "fire": scene.fire_objects, "smoke": scene.smoke_objects,
    }), sort_keys=True)


def _run(code, build, exec_safe, seed):
    random.seed(seed)
    np.random.seed(seed)
    scene = TPE.StubScene()
    exec_safe(code, build(scene), {})
    return scene


@pytest.mark.parametrize(
    "query,code", DEFAULT + WAYMO,
    ids=[f"default-{q[:40]}" for q, _ in DEFAULT]
    + [f"waymo-{q[:40]}" for q, _ in WAYMO])
def test_exemplar_matches_jax(query, code):
    got = _run(code, port_dsl_vars, LMP.exec_safe, 7)
    want = _run(code, TPE.build_dsl_vars, JLMP.exec_safe, 7)
    assert _state(got) == _state(want)
    assert got.inserted_objects or got.events or got.fire_objects \
        or got.smoke_objects


def test_exemplar_counts_and_prompts_equal_jax():
    assert (len(DEFAULT), len(WAYMO)) == (26, 17)
    for name in ("planner_prompt.txt", "planner_prompt_waymo.txt"):
        with open(os.path.join(PROMPTS, name), "rb") as f:
            got = f.read()
        with open(os.path.join(TPE.PROMPT_DIR, name), "rb") as f:
            assert got == f.read()


def _bound(lmp_module, tmp_path):
    scene = TPE.StubScene()
    scene.cache_dir = str(tmp_path)
    return lmp_module.setup_LMP(scene)["lmp"].variable_vars


def test_dsl_signatures_equal_jax(tmp_path):
    got = _bound(LMP, tmp_path / "port")
    want = _bound(JLMP, tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 34
    for name, fn in got.items():
        assert fn.__module__.startswith("autovfx_tpu_torch."), name
        assert inspect.signature(fn) == inspect.signature(want[name]), name


def test_exec_safe_guards():
    for code in ("import os", "x = ().__class__", "__import__('os')"):
        with pytest.raises(ValueError):
            LMP.exec_safe(code, {}, {})
    for code in ("exec('x = 1')", "eval('1')"):  # stubbed to None
        with pytest.raises(TypeError):
            LMP.exec_safe(code, {}, {})
    with pytest.raises(NameError):  # only the listed builtins
        LMP.exec_safe("open('f')", {}, {})
    out = {}
    LMP.exec_safe("y = len(range(3)) + max(1, 2)", {}, out)
    assert out["y"] == 5


def test_offline_program_matches_jax(tmp_path):
    """``tests/test_edit.py:243-269``'s program through both runners."""
    program = ("obj = make_default_object()\n"
               "obj = translate_object(obj, np.array([0.0, 0.0, 1.0]))\n"
               "obj = allow_physics(obj)\n"
               "insert_object(scene, obj)\n")
    box = TPE._fake_object("box")["object_path"]
    scenes = []
    for name, module, default in (("port", LMP, IR.default_object_info),
                                  ("jax", JLMP, J_default_object_info)):
        scene = TPE.StubScene()
        scene.cache_dir = str(tmp_path / name)
        lmps = module.setup_LMP(scene, offline_program=lambda q: program)

        def make_default_object(default=default):
            o = default()
            o.update(object_path=box, object_id="prog01", scale=0.3,
                     pos=np.zeros(3, np.float32))
            return o

        lmps["lmp"].variable_vars["make_default_object"] = make_default_object
        lmps["lmp"]("drop a box")
        scenes.append(scene)
        with open(os.path.join(scene.cache_dir, "logs_lmp_code_gen.txt")) as f:
            assert "# Query: drop a box." in f.read()
    got, want = scenes
    assert got.inserted_objects[0]["rigid_body"]["rb_type"] == "ACTIVE"
    assert _state(got) == _state(want)


def test_llm_cache_round_trips_across_packages(tmp_path):
    kw = {"query": "drop a ball", "messages": [{"role": "user"}], "model": "m"}
    CACHE.DiskCache(str(tmp_path)).put(kw, "program one")
    assert JCACHE.DiskCache(str(tmp_path)).get(kw) == "program one"
    JCACHE.DiskCache(str(tmp_path)).put(dict(kw, query="b"), "two")
    port = CACHE.DiskCache(str(tmp_path))
    assert port.get(dict(kw, query="b")) == "two" and kw in port
    assert port.get(dict(kw, query="c")) is None


def test_cli_runs_an_offline_program_on_the_cpu(tmp_path):
    from test_torch_edit import JMIO, box_mesh, write_scene

    root = str(tmp_path / "scene")
    os.makedirs(root)
    params = write_scene(root)
    box = os.path.join(root, "box.obj")
    JMIO.save_obj(box, box_mesh(0.5, color=(0.2, 0.2, 0.9)))
    prog = tmp_path / "prog.py"
    prog.write_text(
        "obj = get_default_object_info()\n"
        f"obj['object_path'] = {box!r}\n"
        "obj['object_name'] = 'blue box'\n"
        "obj['object_id'] = 'bluebox1'\n"
        "obj['pos'] = [0.0, 0.0, 0.8]\n"
        "obj['scale'] = 0.3\n"
        "obj = allow_physics(obj)\n"
        "insert_object(scene, obj)\n")
    r = subprocess.run(
        [sys.executable, "-m", "autovfx_tpu_torch.edit_scene",
         "--source_path", root, "--model_path", root,
         "--gaussians_ckpt_path", params["gaussians_ckpt_path"],
         "--scene_mesh_path", params["scene_mesh_path"],
         "--custom_traj_name", "test_traj", "--dup_budget", str(1 << 18),
         "--edit_text", "Put a blue box in the scene.",
         "--offline_program", str(prog), "--device", "cpu"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    cache = os.path.join(root, "cache")
    blended = os.path.join(cache, "blender_output", "blended")
    assert sorted(os.listdir(blended)) == [f"{i:04d}.png" for i in range(4)]
    preamble = os.path.join(cache, "traj", "images")
    assert sorted(f for f in os.listdir(preamble) if f.endswith(".png")) \
        == [f"{i:05d}.png" for i in range(4)]
    cfg = IR.EditConfig.from_json(os.path.join(cache, "edit_config.json"))
    assert cfg.edit_text == "Put a blue box in the scene."
    assert cfg.num_frames == 4
    assert cfg.insert_object_info[0]["object_id"] == "bluebox1"
    rb = cfg.rb_transform["bluebox1"]
    assert rb["3"]["pos"][2] < rb["0"]["pos"][2]


def test_cli_defaults_to_the_card():
    from autovfx_tpu_torch import edit_scene

    opts = edit_scene.get_opts(["--gaussians_ckpt_path", "g.ply",
                                "--edit_text", "x"])
    assert opts.device == "cuda" and opts.dup_budget == 1 << 21
    assert opts.offline_program is None and opts.blender_path is None
