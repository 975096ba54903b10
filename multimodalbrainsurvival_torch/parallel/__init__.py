"""Data, bag and tensor parallelism over ``torch.distributed``: the port's
counterpart of ``multimodalbrainsurvival_tpu/parallel``."""

from multimodalbrainsurvival_torch.parallel.mesh import (
    Mesh,
    activate,
    batch_device_put,
    global_to_host,
    host_to_global,
    initialize_from_env,
    make_mesh,
)
from multimodalbrainsurvival_torch.parallel.sharding import (
    gathered_state_dict,
    joint_param_shardings,
    shard_model,
)

__all__ = [
    "Mesh",
    "activate",
    "batch_device_put",
    "gathered_state_dict",
    "global_to_host",
    "host_to_global",
    "initialize_from_env",
    "joint_param_shardings",
    "make_mesh",
    "shard_model",
]
