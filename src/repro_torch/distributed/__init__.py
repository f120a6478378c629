"""Distribution: the single-controller device mesh, the sharding rules
and the store's shard placement (``distributed.sharding``), the active
mesh of the sequence-sharded decode (``distributed.runtime``); fault
tolerance for the sharded serving path and the trainer: checkpoints,
liveness, promotion policy, elastic re-planning and straggler mitigation
(``distributed.fault``); gradient compression with error feedback
(``distributed.compression``)."""

from .fault import (CheckpointManager, ElasticPlanner,  # noqa: F401
                    HeartbeatMonitor, MeshPlan, StragglerMitigator,
                    most_caught_up, tree_flatten, tree_map,
                    tree_unflatten)
from .sharding import (STRATEGIES, Mesh, NamedSharding,  # noqa: F401
                       PartitionSpec, auto_pspec, batch_pspec,
                       cache_pspecs, key_shard_mesh, named_shardings,
                       param_pspecs, stacked_store_sharding)
