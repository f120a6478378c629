"""Fault tolerance for the sharded serving path and the trainer:
checkpoints, liveness, promotion policy, elastic re-planning and
straggler mitigation (``distributed.fault``); gradient compression with
error feedback (``distributed.compression``)."""

from .fault import (CheckpointManager, ElasticPlanner,  # noqa: F401
                    HeartbeatMonitor, MeshPlan, StragglerMitigator,
                    most_caught_up, tree_flatten, tree_map,
                    tree_unflatten)
