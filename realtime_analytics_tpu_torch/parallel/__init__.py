"""Multi-device scaling: device meshes, shardings, sharded train and
inference steps, in one process.

  * ``mesh``   — mesh construction, the sharding rule, the sharded forward
    (``ShardedModel``) and ``dp_map`` (the kernels' dp forms)
  * ``train``  — the detection train step (loss, backward, AdamW) on one
    device or over a (dp, tp) mesh
  * ``dryrun`` — ``dryrun_multichip``: the sharded train step and sharded
    inference on YOLOv8n at 64²
"""

from .mesh import (  # noqa: F401
    Mesh,
    ShardedModel,
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
    shard_params,
)
from .train import (  # noqa: F401
    TrainState,
    anchor_centers,
    detection_loss,
    make_train_step,
    synthetic_targets,
)
