from .mesh import (
    Mesh, choose_backend, init_distributed, make_mesh, replicate_state, shard_batch,
    shard_train_step, visible_devices,
)
from .tp import gather_state, partition_specs, shard_state
from .launch import start_ranks
