"""The parallel paths of the port (``parallel/__init__.py`` of the JAX
package): the fold-parallel step, the process group's start and the
global batches of ``multihost.py``, and the meshes, layouts and sharded
train steps of ``sharding.py``. The GPipe pipeline (JAX
``parallel/pipeline.py``) is not ported yet."""
from .foldparallel import (
    make_foldwise_train_step,
    stack_fold_states,
    train_folds_parallel,
    unstack_fold_state,
)
from .multihost import global_batch_dict, initialize_distributed, make_global_batch
from .sharding import (
    batch_sharding,
    fsdp_variable_shardings,
    image_sharding,
    make_fsdp_train_step,
    make_mesh_2d,
    make_mesh_3d,
    make_mesh_spatial,
    make_sharded_train_step,
    make_spatial_eval_step,
    make_zero1_train_step,
    variable_shardings,
    zero1_state_shardings,
)
