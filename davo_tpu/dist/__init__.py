"""Distribution layer: device mesh, sharding rules, collectives,
multi-host bootstrap.

The reference has no parallelism at all (1 process / 1 GPU,
SURVEY.md §2.2 [H]); this layer is the communication backend: named mesh axes ('data', 'model', 'window'), NamedSharding
rule tables, jit/GSPMD for the training step (XLA inserts psum), and
explicit shard_map + collectives for the BA backend and ring pipelines.
"""

from davo_tpu.dist.mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    replicated,
    shard_batch,
)
from davo_tpu.dist.train import make_sharded_train_step, shard_state  # noqa: F401
