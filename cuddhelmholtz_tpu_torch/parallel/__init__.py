"""Multi-device execution on ``torch.distributed`` (one process per device)."""

from .distributed import (  # noqa: F401
    hybrid_device_mesh,
    initialize_from_env,
    spawn_cpu_processes,
    spawn_processes,
)
from .sharding import (  # noqa: F401
    ShardedDDH,
    device_mesh,
    shard_mass_op,
    shard_stiffness_op,
    sharded_helmholtz_matvec,
    sharded_mass_apply,
    sharded_stiffness_apply,
)
