"""Record the JAX package's outputs for the port's costliest parity tests.

Each recording is the JAX side of one test fixture, computed from the
live ``autovfx_tpu`` package on the CPU on exactly the inputs, seeds,
monkeypatches and contexts the test builds (the tests' own helpers
build them here), and written to ``tests/golden/torch/`` with the JAX
version and the digest of those inputs (``tests/torch_references.py``).
The tests read them back and run only the port's side.

Run:  python scripts/gen_torch_references.py [NAME ...] [--out DIR]

With no NAME it writes every recording; the same command rebuilds each
file byte for byte (``python -m pytest -m slow
tests/test_torch_references.py`` checks that).
"""
import argparse
import copy
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
for path in (REPO, TESTS):
    if path not in sys.path:
        sys.path.insert(0, path)

import conftest  # noqa: E402,F401  the tests' JAX settings (CPU, 8 devices)
import numpy as np  # noqa: E402
import jax  # noqa: E402

import torch_references as REF  # noqa: E402


# ---- the edits (tests/test_torch_edit*.py) ----------------------------------


def _jax_scene(root, params, obj, edits):
    """The JAX scene of ``test_torch_edit.scenes`` with ``obj`` inserted
    after the DSL ``edits``."""
    import test_torch_edit as TE

    js = TE.JSR.SceneRepresentation(TE.JSR.SceneParams(
        cache_dir=os.path.join(root, "jax_cache"), **params))
    o = copy.deepcopy(obj)
    for name in edits:
        o = getattr(TE.JEU, name)(o)
    TE.JEU.insert_object(js, o)
    return js


def edit_drop(root):
    import test_torch_edit as TE

    params, obj, key = TE.drop_inputs(root)
    js = _jax_scene(root, params, obj, ["allow_physics"])
    calls = []
    TE.spy(js, "render_from_3DGS", calls)
    with TE.jax_reference():
        frames = np.asarray(js.render_scene())
    config = TE.normalized_config(
        os.path.join(js.cache_dir, "edit_config.json"),
        os.path.join(root, "jax_cache"), root)
    return key, dict(frames=frames, render_from_3DGS=[list(calls[0])],
                     rb_transform=js.rb_transform, edit_config=config)


def _run_edit(root, edit, after=None):
    """``test_torch_edit.run_edit``'s JAX side for a module's ``EDIT``: its
    scene, and its frames under ``jax_reference``."""
    import test_torch_edit as TE

    params, obj, key = TE.run_edit_inputs(root, **edit)
    js = _jax_scene(root, params, obj, ["allow_physics", *edit["edits"]])
    out = {} if after is None else after(js)
    with TE.jax_reference():
        out["frames"] = np.asarray(js.render_scene(save=False))
    out["rb_transform"] = js.rb_transform
    return key, js, out


def _fragments(js):
    return {oid: [dict(visible_from=p["visible_from"],
                       object={"object_id": p["object"]["object_id"]},
                       faces=p["faces"], vertices=p["vertices"])
                  for p in pieces]
            for oid, pieces in js._fragments.items()}


def edit_break(root):
    import test_torch_edit_break

    key, js, out = _run_edit(root, test_torch_edit_break.EDIT)
    return key, dict(out, fragments=_fragments(js))


def edit_fracture(root):
    import test_torch_edit_fracture

    key, js, out = _run_edit(root, test_torch_edit_fracture.EDIT)
    return key, dict(out, fragments=_fragments(js))


def edit_effects(root):
    """``test_torch_edit_effects.burning``: the cube set on fire after the
    melting edit, its smoke trajectory simulated before the render: its
    density and temperature, since no render reads the solver's
    velocity (a third of the file)."""
    import test_torch_edit_effects
    from autovfx_tpu.edit import edit_utils as JEU

    def fire(js):
        JEU.add_fire(js, js.inserted_objects[0])
        states, origin, extent, cfg, cells = js._smoke_trajectory()
        fields = dict(density=states.density, temperature=states.temperature)
        return dict(smoke_traj=dict(states=fields, origin=origin,
                                    extent=extent, cfg=cfg._asdict(),
                                    cells=cells))

    key, js, out = _run_edit(root, test_torch_edit_effects.EDIT, after=fire)
    melt = js._melt_sims["cube01"][1]
    out["melt_frames"] = {f: getattr(melt, f) for f in (
        "h", "eta", "tracer_pos", "tracer_fluid", "volume")}
    out["fire_objects"] = list(js.fire_objects)
    return key, out


# ---- the edited frame (tests/test_torch_clip.py, _effects_clip.py) ----------


def clip(root):
    """``test_torch_clip.jax_frame``, with the Pallas kernels in
    interpret mode as in that file."""
    import pytest
    import test_torch_clip as TC
    from autovfx_tpu.core import cameras as JC
    from autovfx_tpu.core.gaussians import merge
    from autovfx_tpu.ops.rasterize import rasterize
    from autovfx_tpu.render import clip as JCL

    inp, cfg = TC.clip_setup()
    with pytest.MonkeyPatch.context() as mp:
        TC.interpret(mp)
        cam = JC.index_camera(inp.cams, 0)
        g_obj = JCL.shaded_object_gaussians(inp, 0, cam)
        ref = rasterize(merge(inp.bg, g_obj), cam,
                        config=cfg.replace(backend="ref"))
        fused = JCL.render_edited_frame_fused(inp, 0, cfg, shadow_scale=2)
    return TC.jax_inputs_digest(inp, cfg), dict(
        merged_ref=dict(color=ref.color, alpha=ref.alpha, depth=ref.depth),
        fused=fused)


def effects_clip(root):
    """``test_torch_effects_clip.jax_fused``, in interpret mode as in
    that file."""
    import pytest
    import test_torch_effects_clip as TEC

    c = TEC.clip_inputs()
    _, jcfg = TEC.smoke_cfgs()
    frames = {}
    with pytest.MonkeyPatch.context() as mp:
        TEC.interpret(mp)
        for case, frame in TEC.FUSED_CASES:
            frames[f"{case}_{frame}"] = TEC.JCL.render_edited_frame_fused(
                c["jax"][case], frame, c["cfg"], shadow_scale=1,
                smoke_cfg=jcfg)
    return TEC.fused_inputs_digest(c), frames


# ---- training (tests/test_torch_train.py) -----------------------------------


def _train_grad(tile):
    """``test_torch_train.test_gradients_match_jax_grad``'s ``jax.grad``
    for its case at ``tile``."""
    import jax.numpy as jnp
    import test_torch_train as TT
    from autovfx_tpu.ops.rasterize import RasterConfig, rasterize

    (case,) = [c for c in TT.GRAD_CASES if c[0] == tile]
    n = case[1]
    g, cam, gc, gd, ga, bg, key = TT.gradient_inputs(*case)
    jcfg = RasterConfig(dup_budget=TT.BUDGET, backend="ref", tile=tile)

    def j_loss(params, offset):
        out = rasterize(g.replace(**params), cam, bg=jnp.asarray(bg),
                        config=jcfg, mean2d_offset=offset)
        return (jnp.sum(out.color * gc) + jnp.sum(out.depth * gd)
                + jnp.sum(out.alpha * ga))

    params = {f: getattr(g, f) for f in TT.PARAMS}
    j_params, j_off = jax.grad(j_loss, argnums=(0, 1))(
        params, jnp.zeros((n, 2), jnp.float32))
    return key, dict(params=j_params, mean2d_offset=j_off)


def train_grad_16(root):
    return _train_grad(16)


def train_grad_32(root):
    return _train_grad(32)


def train_offset(root):
    """``test_mean2d_offset_render_matches_jax``'s JAX render."""
    import jax.numpy as jnp
    import test_torch_train as TT
    from autovfx_tpu.ops.rasterize import RasterConfig, rasterize

    g, cam, off, key = TT.offset_inputs()
    out = rasterize(g, cam, config=RasterConfig(dup_budget=TT.BUDGET,
                                                backend="ref"),
                    mean2d_offset=jnp.asarray(off))
    return key, dict(color=out.color, depth=out.depth, alpha=out.alpha)


def _regularized(pseudo_normal):
    """``test_torch_train._regularized``'s ``jax.value_and_grad``."""
    import jax.numpy as jnp
    import test_torch_train as TT
    from autovfx_tpu.ops.rasterize import RasterConfig
    from autovfx_tpu.train import trainer as JT

    g, cam, rgb, depth, normal, kw, key = TT.regularized_inputs(
        pseudo_normal)
    jcfg = JT.TrainConfig(raster=RasterConfig(dup_budget=TT.BUDGET,
                                              backend="ref"), **kw)

    def j_loss(params):
        return JT.compute_loss(g.replace(**params), jnp.zeros((120, 2)), cam,
                               jnp.asarray(rgb), jcfg, jnp.asarray(depth),
                               jnp.asarray(normal))[0]

    j_val, j_grads = jax.value_and_grad(j_loss)(
        {f: getattr(g, f) for f in TT.PARAMS})
    return key, dict(value=j_val, grads=j_grads)


def train_regularized(root):
    return _regularized(0.0)


def train_pseudo_normal(root):
    return _regularized(0.1)


def train_step(root):
    """``test_train_step_matches_jax``'s JAX ``train_step``."""
    import jax.numpy as jnp
    import test_torch_train as TT
    from autovfx_tpu.ops.rasterize import RasterConfig
    from autovfx_tpu.train import trainer as JT

    g, cam, target, key = TT.step_inputs()
    jcfg = JT.TrainConfig(raster=RasterConfig(dup_budget=TT.BUDGET,
                                              backend="ref"))
    state, aux = JT.train_step(JT.init_state(g), cam, jnp.asarray(target),
                               jcfg)
    return key, dict(loss=aux.loss, psnr=aux.psnr, overflow=aux.overflow,
                     step=state.step, max_radii=state.stats.max_radii,
                     denom=state.stats.denom,
                     grad_accum=state.stats.grad_accum)


# ---- retrieval (tests/test_torch_retrieval.py) ------------------------------


def previews(root):
    """``test_torch_retrieval.previews``'s JAX side: the previews under
    ``jax_reference`` with a jitted ``rasterize``, each PNG as PIL reads
    it."""
    import pytest
    import test_torch_retrieval as TR
    from PIL import Image
    from autovfx_tpu.render import preview as JPV
    from test_torch_edit import jax_reference

    obj, key = TR.preview_inputs(root)
    with jax_reference(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPV, "rasterize", jax.jit(JPV.rasterize,
                                             static_argnames=("config",)))
        out = JPV.render_asset_previews(obj, os.path.join(root, "jax"),
                                        "basketball", size=64)
    return key, {name: np.asarray(Image.open(os.path.join(out, name)))
                 for name in sorted(os.listdir(out))}


# ---- removal (tests/test_torch_inpaint_retrain.py) --------------------------


def removal(root):
    """``test_torch_inpaint_retrain.removal``'s JAX side: the files
    ``inpaint_object`` writes into the JAX base, under ``jax_reference``
    with no LaMa checkpoint."""
    import pytest
    import test_torch_inpaint_retrain as TI
    from autovfx_tpu.perception import extract
    from test_torch_edit import jax_reference

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("AUTOVFX_LAMA_CKPT", raising=False)
        mp.setenv("HOME", root)
        _, js, _, jbase, _, key = TI.removal_inputs(root)
        before = TI._tree(jbase)
        with jax_reference():
            extract.inpaint_object(js, "box", 1)
    written = {rel: np.frombuffer(data, np.uint8)
               for rel, data in TI._tree(jbase).items()
               if before.get(rel) != data}
    return key, {"files": written}


# ---- the parallel layer (tests/test_torch_parallel.py) ----------------------


def _parallel(d):
    """``test_torch_parallel.world``'s JAX side over ``jax.devices()[:d]``
    under ``jax.jit`` (eager ``shard_map`` dispatches op by op): the DP
    step, the sharded composites and the distributed build (of its slabs,
    the rows the test reads)."""
    import jax.numpy as jnp
    import test_torch_parallel as TP
    from autovfx_tpu.parallel import sharding as JS
    from autovfx_tpu.parallel.mesh import make_mesh
    from autovfx_tpu.train import trainer as JT

    jin, key = TP.world_inputs(d)
    cams, bg, scene, cam = (jin[k] for k in ("cams", "bg", "scene", "cam"))
    devs = jax.devices()[:d]
    cfg = TP.CFG
    imgs = TP.dp_images(jin, d)
    jcfg = JT.TrainConfig(raster=cfg)
    mesh_dp = make_mesh((d, 1), devices=devs)
    jstate, jaux = jax.jit(lambda s, c, im: JS.dp_train_step(
        s, c, im, jcfg, mesh_dp))(JT.init_state(jin["g_train"]), cams, imgs)
    mesh_g = make_mesh((1, d), devices=devs)
    full = JS.shard_gaussians(scene, cam, d)
    compact, _ = JS.shard_gaussians_compact(scene, cam, d, slack=0.5)
    build = jax.jit(lambda st: JS.distributed_shard_compact(
        st, cam, mesh_g, slack=0.6))
    dist, d_ovf = build(JS.round_robin_store(scene, d))
    composite = jax.jit(lambda gs: JS.sharded_render_compact(
        gs, cam, mesh_g, config=cfg, bg=bg))
    flat = scene.replace(xyz=jnp.zeros_like(scene.xyz))
    state = {}
    for prefix, tree in (("g_", jstate.gaussians), ("m_", jstate.adam.m),
                         ("v_", jstate.adam.v)):
        state.update({prefix + f: v for f, v in TP.g_arrays(tree).items()})
    state.update({"stats_" + f: getattr(jstate.stats, f)
                  for f in ("max_radii", "denom", "grad_accum")})
    return key, {
        "dp": dict(state=state, aux=dict(loss=jaux.loss, psnr=jaux.psnr,
                                         overflow=jaux.overflow)),
        "full": jax.jit(lambda gs: JS.sharded_render(
            gs, cam, mesh_g, config=cfg, bg=bg))(full),
        "compact": composite(compact),
        "dist_slabs": dict(xyz=dist.xyz, active=dist.active),
        "dist_overflow": bool(d_ovf), "dist": composite(dist),
        # one slab holds every splat: a (source, slab) pair overflows
        # its block at any slack below D - 1
        "flat_pair_overflow": bool(build(JS.round_robin_store(flat, d))[1]),
    }


def parallel_D2(root):
    return _parallel(2)


def parallel_D4(root):
    return _parallel(4)


RECORDINGS = {f.__name__: f for f in (
    edit_drop, edit_break, edit_fracture, edit_effects, clip, effects_clip,
    train_grad_16, train_grad_32, train_offset, train_regularized,
    train_pseudo_normal, train_step, previews, removal, parallel_D2,
    parallel_D4)}


def write(name: str, out_dir: str) -> float:
    """Record ``name`` into ``out_dir``; its seconds."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        key, tree = RECORDINGS[name](tmp)
        REF.save(out_dir, name, key, tree, jax.__version__)
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help="recordings to write (default: all): "
                    + ", ".join(sorted(RECORDINGS)))
    ap.add_argument("--out", default=REF.DIR)
    args = ap.parse_args(argv)
    unknown = set(args.names) - set(RECORDINGS)
    if unknown:
        ap.error(f"no recording named {', '.join(sorted(unknown))}")
    for name in args.names or sorted(RECORDINGS):
        print(f"{name}: {write(name, args.out):.1f} s", flush=True)


if __name__ == "__main__":
    main()
