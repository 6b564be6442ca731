"""LMP (Language-Model-Program) engine: GPT writes edit programs.

Counterpart of ``autovfx_tpu/gpt/lmp.py``; ``setup_LMP`` binds this
package's DSL (``edit.edit_utils``).  Reference ``gpt/LMP.py`` (adapted
from VoxPoser/Code-as-Policies):
- build_prompt few-shot assembly (:37-56) + chat-message split (:60-101)
- cached API call, temp 0, stop "# Query: " (:58-119, cfg code_gen.py:14-32)
- exec_safe sandbox banning import/__ and stubbing exec/eval (:199-212)
- the injected preamble that constructs the scene, renders the original
  video first and the edited result after the generated code (:220-231)
- every generated program appended to logs_lmp_code_gen.txt
  (edit_scene.py:33-35, LMP.py:215-217).

Model access: OpenAI-compatible chat API via requests when
``OPENAI_API_KEY`` is set; otherwise programs must be supplied via
``offline_program`` / the cache (reruns stay reproducible either way).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

from autovfx_tpu_torch.gpt.cache import DiskCache

DEFAULT_CFG = {
    "model": "gpt-4-1106-preview",
    "temperature": 0.0,
    "max_tokens": 2048,
    "stop": "# Query: ",
    "query_prefix": "# Query: ",
    "query_suffix": ".",
    "maintain_session": False,
    "include_context": True,
}

_BANNED = ("import", "__")


def exec_safe(code_str: str, gvars: dict, lvars: dict) -> None:
    """gpt/LMP.py:199-212: ban import/dunder, stub exec/eval."""
    for phrase in _BANNED:
        if phrase in code_str:
            raise ValueError(
                f"generated code contains banned phrase: {phrase!r}"
            )
    safe_gvars = dict(gvars)
    safe_gvars.update({"exec": None, "eval": None, "__builtins__": None})
    # minimal builtins the DSL programs rely on
    import builtins

    allowed = {
        n: getattr(builtins, n)
        for n in (
            "range", "len", "enumerate", "zip", "min", "max", "abs",
            "float", "int", "list", "dict", "tuple", "print", "sorted",
            "sum", "round", "str", "bool",
        )
    }
    safe_gvars["__builtins__"] = allowed
    exec(code_str, safe_gvars, lvars)


class LMP:
    def __init__(
        self,
        name: str,
        cfg: Optional[dict] = None,
        fixed_vars: Optional[dict] = None,
        variable_vars: Optional[dict] = None,
        prompt_path: Optional[str] = None,
        cache_dir: str = "_cache/llm_cache",
        log_path: str = "logs_lmp_code_gen.txt",
        offline_program: Optional[Callable[[str], str]] = None,
    ):
        self.name = name
        self.cfg = {**DEFAULT_CFG, **(cfg or {})}
        self.fixed_vars = fixed_vars or {}
        self.variable_vars = variable_vars or {}
        if prompt_path is None:
            prompt_path = os.path.join(
                os.path.dirname(__file__), "prompts", "planner_prompt.txt"
            )
        with open(prompt_path) as f:
            self.prompt_examples = f.read().strip()
        self.cache = DiskCache(cache_dir)
        self.log_path = log_path
        self.offline_program = offline_program
        self.exec_hist = ""

    # ---- prompt assembly (LMP.py:37-101) ------------------------------------

    def build_prompt(self, query: str) -> str:
        prompt = self.prompt_examples
        if self.cfg["maintain_session"] and self.exec_hist:
            prompt += f"\n{self.exec_hist}"
        user_query = (
            f"{self.cfg['query_prefix']}{query}{self.cfg['query_suffix']}"
        )
        return f"{prompt}\n\n{user_query}", user_query

    def _messages(self, prompt: str):
        # split few-shot examples into alternating user/assistant turns
        chunks = prompt.split(self.cfg["query_prefix"])
        system = chunks[0].strip()
        messages = [
            {
                "role": "system",
                "content": (
                    "You are a Python program synthesizer for 3D scene "
                    "editing. Reply with code only.\n" + system
                ),
            }
        ]
        for chunk in chunks[1:]:
            lines = chunk.split("\n")
            q = lines[0]
            code = "\n".join(lines[1:]).strip()
            messages.append(
                {"role": "user", "content": self.cfg["query_prefix"] + q}
            )
            if code:
                messages.append({"role": "assistant", "content": code})
        return messages

    # ---- model call (LMP.py:58-119) -------------------------------------------

    def _cached_api_call(self, **kwargs) -> str:
        hit = self.cache.get(kwargs)
        if hit is not None:
            print(f"(using cache for {self.name})")
            return hit
        if self.offline_program is not None:
            out = self.offline_program(kwargs["query"])
            self.cache.put(kwargs, out)
            return out
        key = os.environ.get("OPENAI_API_KEY")
        if not key:
            raise RuntimeError(
                "No OPENAI_API_KEY and no offline_program/cache entry — "
                "cannot synthesize an edit program."
            )
        import requests

        messages = kwargs["messages"]
        for attempt in range(5):
            try:
                t0 = time.time()
                resp = requests.post(
                    "https://api.openai.com/v1/chat/completions",
                    headers={"Authorization": f"Bearer {key}"},
                    json={
                        "model": self.cfg["model"],
                        "messages": messages,
                        "temperature": self.cfg["temperature"],
                        "max_tokens": self.cfg["max_tokens"],
                        "stop": self.cfg["stop"],
                    },
                    timeout=180,
                )
                resp.raise_for_status()
                out = resp.json()["choices"][0]["message"]["content"]
                print(f"*** OpenAI API call took {time.time() - t0:.2f}s ***")
                self.cache.put(kwargs, out)
                return out
            except Exception as e:  # rate limits / transient (LMP.py:135-138)
                print(f"OpenAI API got err {e}; retrying after 3s")
                time.sleep(3)
        raise RuntimeError("OpenAI API failed after retries")

    # ---- execution --------------------------------------------------------------

    def __call__(self, query: str, **extra_vars):
        prompt, user_query = self.build_prompt(query)
        code_str = self._cached_api_call(
            query=query,
            messages=self._messages(prompt),
            model=self.cfg["model"],
        )
        code_str = _strip_fences(code_str)

        with open(self.log_path, "a") as f:
            f.write(f"{user_query}\n{code_str}\n\n")

        gvars = {**self.fixed_vars, **self.variable_vars, **extra_vars}
        lvars: Dict = {}
        print(f"LMP {self.name} generated code:\n{code_str}")
        exec_safe(code_str, gvars, lvars)
        self.exec_hist += f"\n{user_query}\n{code_str}"
        return lvars


def _strip_fences(code: str) -> str:
    code = code.strip()
    if code.startswith("```"):
        lines = code.split("\n")
        lines = lines[1:]
        if lines and lines[-1].strip().startswith("```"):
            lines = lines[:-1]
        code = "\n".join(lines)
    return code.strip()


def setup_LMP(
    scene_representation,
    cfg: Optional[dict] = None,
    offline_program: Optional[Callable[[str], str]] = None,
    waymo: bool = False,
):
    """Build the plan_ui LMP with the edit DSL in scope (code_gen.py:35-46).

    The returned callable runs: render original 3DGS video → generated
    edit program → full edited render (the reference preamble,
    LMP.py:220-231)."""
    import numpy as np

    from autovfx_tpu_torch.edit import edit_utils as EU

    dsl = {
        name: getattr(EU, name)
        for name in (
            "detect_object", "sample_point_on_object",
            "sample_point_above_object", "retrieve_asset", "insert_object",
            "remove_object", "update_object", "allow_physics", "add_fire",
            "add_smoke", "set_static_animation", "set_moving_animation",
            "retrieve_material", "init_material", "apply_material",
            "allow_fracture", "get_object_bottom_position",
            "get_object_center_position", "translate_object",
            "rotate_object", "scale_object", "get_random_2D_rotation",
            "get_random_3D_rotation", "make_copy", "make_break",
            "make_melting", "get_camera_position", "add_event",
            "get_vehicle_position", "get_direction", "retrieve_chatsim_asset",
        )
    }
    # schema constructors the reference also exposes to programs
    # (edit_utils.py:67-114: get_default_object_info /
    # get_default_event_info / Material)
    from autovfx_tpu_torch.edit.edit_ir import (
        default_event_info,
        default_object_info,
    )

    dsl["get_default_object_info"] = default_object_info
    dsl["get_default_event_info"] = default_event_info
    dsl["Material"] = EU.Material

    # generated programs pass `scene` explicitly (prompt convention),
    # matching the reference's variable_vars wiring (code_gen.py:35-46)
    scene_bound = dsl
    fixed_vars = {"np": np, "scene": scene_representation}
    prompt = (
        "planner_prompt_waymo.txt" if waymo else "planner_prompt.txt"
    )
    lmp = LMP(
        "plan_ui",
        cfg=cfg,
        fixed_vars=fixed_vars,
        variable_vars=scene_bound,
        prompt_path=os.path.join(
            os.path.dirname(__file__), "prompts", prompt
        ),
        cache_dir=os.path.join(
            scene_representation.cache_dir, "llm_cache"
        ),
        log_path=os.path.join(
            scene_representation.cache_dir, "logs_lmp_code_gen.txt"
        ),
        offline_program=offline_program,
    )

    def plan_ui(edit_text: str, render: bool = True):
        if render:
            scene_representation.render_from_3DGS(
                save_dir=os.path.join(
                    scene_representation.traj_results_dir, "images"
                )
            )
        lmp(edit_text)
        if render:
            return scene_representation.render_scene()
        return None

    return {"plan_ui": plan_ui, "lmp": lmp}
