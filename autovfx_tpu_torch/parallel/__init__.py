"""Multi-rank training and rendering over ``torch.distributed``:
process meshes (``mesh``), camera data-parallel training and depth-slab
sharded rendering (``sharding``), a process launcher (``launch``) and
the dry run (``dryrun``)."""
from autovfx_tpu_torch.parallel.mesh import make_mesh
from autovfx_tpu_torch.parallel.sharding import (
    dp_train_step,
    sharded_render,
)

__all__ = ["make_mesh", "dp_train_step", "sharded_render"]
