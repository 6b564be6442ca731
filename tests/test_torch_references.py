"""The recorded JAX outputs of ``tests/golden/torch/``
(``tests/torch_references.py``) against the inputs their tests build and
against the live JAX package.

- each recording's inputs digest equals the digest of the inputs its
  test builds today, and every recording the generator makes is here;
- (slow) ``scripts/gen_torch_references.py`` rebuilds every recording
  from the live JAX package byte for byte.
"""
import filecmp
import importlib.util
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

import test_torch_clip as TC  # noqa: E402
import test_torch_edit as TE  # noqa: E402
import test_torch_edit_break  # noqa: E402
import test_torch_edit_effects  # noqa: E402
import test_torch_edit_fracture  # noqa: E402
import test_torch_effects_clip as TEC  # noqa: E402
import test_torch_inpaint_retrain as TI  # noqa: E402
import test_torch_parallel as TP  # noqa: E402
import test_torch_retrieval as TR  # noqa: E402
import test_torch_train as TT  # noqa: E402
import torch_references as REF  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _generator():
    spec = importlib.util.spec_from_file_location(
        "gen_torch_references",
        os.path.join(REPO, "scripts", "gen_torch_references.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grad(tile):
    (case,) = [c for c in TT.GRAD_CASES if c[0] == tile]
    return lambda root: TT.gradient_inputs(*case)[-1]


# each recording: the digest of the inputs its test builds in ``root``
INPUTS = {
    "edit_drop": lambda root: TE.drop_inputs(root)[-1],
    "edit_break": lambda root: TE.run_edit_inputs(
        root, **test_torch_edit_break.EDIT)[-1],
    "edit_fracture": lambda root: TE.run_edit_inputs(
        root, **test_torch_edit_fracture.EDIT)[-1],
    "edit_effects": lambda root: TE.run_edit_inputs(
        root, **test_torch_edit_effects.EDIT)[-1],
    "clip": lambda root: TC.jax_inputs_digest(*TC.clip_setup()),
    "effects_clip": lambda root: TEC.fused_inputs_digest(TEC.clip_inputs()),
    "train_grad_16": _grad(16),
    "train_grad_32": _grad(32),
    "train_offset": lambda root: TT.offset_inputs()[-1],
    "train_regularized": lambda root: TT.regularized_inputs(0.0)[-1],
    "train_pseudo_normal": lambda root: TT.regularized_inputs(0.1)[-1],
    "train_step": lambda root: TT.step_inputs()[-1],
    "previews": lambda root: TR.preview_inputs(root)[1],
    "removal": lambda root: TI.removal_inputs(root)[-1],
    "parallel_D2": lambda root: TP.world_inputs(2)[1],
    "parallel_D4": lambda root: TP.world_inputs(4)[1],
}


def test_every_recording_is_generated_and_checked():
    files = sorted(os.listdir(REF.DIR))
    names = sorted(_generator().RECORDINGS)
    assert sorted(INPUTS) == names
    assert files == sorted(n + ext for n in names for ext in (".json", ".npz"))


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_recording_matches_its_tests_inputs(name, tmp_path):
    meta = REF.meta(name)
    assert meta["inputs_digest"] == INPUTS[name](str(tmp_path)), name
    assert meta["jax_version"]


@pytest.mark.slow
def test_recordings_rebuild_byte_for_byte(tmp_path):
    gen = _generator()
    for name in sorted(gen.RECORDINGS):
        gen.write(name, str(tmp_path))
    files = sorted(os.listdir(REF.DIR))
    assert sorted(os.listdir(tmp_path)) == files
    for f in files:
        assert filecmp.cmp(os.path.join(REF.DIR, f), str(tmp_path / f),
                           shallow=False), f
