"""Edited-frame rendering: envmap IBL, object surfels, hull shadows, the
composite and the clip loop; smoke, fire and liquid melt; DiffusionLight
envmaps and panoramas.

The package also exports a function ``render`` (``ops.rasterize.render``),
and importing this subpackage rebinds ``autovfx_tpu_torch.render`` to
it; so that ``autovfx_tpu_torch.render(g, cam, ...)`` keeps working,
calling this module calls that function.
"""
import sys
import types


class _CallableModule(types.ModuleType):
    def __call__(self, *args, **kwargs):
        from autovfx_tpu_torch.ops.rasterize import render

        return render(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
