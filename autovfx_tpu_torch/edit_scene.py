"""Language-driven scene editing CLI of the port.

Counterpart of the repository's ``edit_scene.py``: the same flags and
defaults, plus ``--device`` (``cuda`` unless the CPU is asked for).  It
builds the scene, runs the ``plan_ui`` program runner (the original
video's render, the edit program over the DSL, the edit's render) and
writes the frames and the edit config under the scene's cache.

Example (on the card; add ``--device cpu`` for the plain path):

    python -m autovfx_tpu_torch.edit_scene --source_path data/garden \\
        --gaussians_ckpt_path output/garden/scene.ply \\
        --scene_mesh_path output/garden/mesh.obj \\
        --custom_traj_name transforms_001 \\
        --edit_text "Drop a cube on the table." \\
        --offline_program program.py
"""
import argparse


def get_opts(argv=None):
    """The reference's flag surface (its ``opt.py``) and ``--device``;
    ``argv`` defaults to the process's arguments."""
    p = argparse.ArgumentParser()
    p.add_argument("--source_path", type=str, default="")
    p.add_argument("--model_path", type=str, default="")
    p.add_argument("--gaussians_ckpt_path", type=str, required=True)
    p.add_argument("--scene_mesh_path", type=str, default="")
    p.add_argument("--custom_traj_name", type=str, default=None)
    p.add_argument("--anchor_frame_idx", type=int, default=0)
    p.add_argument("--scene_scale", type=float, default=1.0)
    p.add_argument("--downscale_factor", type=float, default=1.0)
    p.add_argument("--render_type", type=str, default="MULTI_VIEW",
                   choices=["MULTI_VIEW", "SINGLE_VIEW"])
    p.add_argument("--num_frames", type=int, default=1)
    p.add_argument("--max_sh_degree", type=int, default=4)
    p.add_argument("--is_uv_mesh", action="store_true")
    p.add_argument("--is_indoor_scene", action="store_true")
    p.add_argument("--waymo_scene", action="store_true")
    p.add_argument("--deva_dino_threshold", type=float, default=0.45)
    p.add_argument("--edit_text", type=str, required=True)
    p.add_argument("--blender_output_dir_name", type=str,
                   default="blender_output")
    p.add_argument("--env_map_path", type=str, default=None)
    p.add_argument("--dup_budget", type=int, default=1 << 21)
    p.add_argument("--offline_program", type=str, default=None,
                   help="path to a Python file with the edit program "
                        "(skips the GPT call)")
    p.add_argument("--emitter_mesh_path", type=str, default=None,
                   help="emitter mesh (.obj) for indoor scenes")
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the scene lives and renders on "
                        "(cpu: the kernels' plain versions)")
    # Blender-era flags accepted for drop-in compatibility; the
    # in-process renderer replaces the Blender subprocess
    p.add_argument("--blender_path", type=str, default=None,
                   help="ignored (no Blender subprocess in this build)")
    p.add_argument("--blender_config_name", type=str, default=None,
                   help="ignored (the edit IR JSON is written automatically)")
    return p.parse_args(argv)


def run_scene_editing(hparams, edit_text, offline_program=None):
    """Build the scene from ``hparams`` and run ``edit_text`` through
    ``plan_ui``: the (F, H, W, 3) edited frames on ``hparams.device``.
    ``offline_program`` is a file whose program replaces the model's."""
    from autovfx_tpu_torch.edit.scene_representation import (
        SceneParams,
        SceneRepresentation,
    )
    from autovfx_tpu_torch.gpt.lmp import setup_LMP

    params = SceneParams(
        **{
            k: getattr(hparams, k)
            for k in SceneParams.__dataclass_fields__
            if hasattr(hparams, k)
        }
    )
    scene = SceneRepresentation(params)
    offline = None
    if offline_program:
        with open(offline_program) as f:
            program_text = f.read()
        offline = lambda query: program_text
    lmps = setup_LMP(
        scene, offline_program=offline, waymo=hparams.waymo_scene
    )
    return lmps["plan_ui"](edit_text)


if __name__ == "__main__":
    hparams = get_opts()
    with open("logs_lmp_code_gen.txt", "a") as f:
        f.write(f"\n=== {hparams.edit_text}\n")
    run_scene_editing(hparams, hparams.edit_text, hparams.offline_program)
