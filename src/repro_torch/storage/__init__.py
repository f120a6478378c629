"""Online time-series store (unsharded and key-sharded), per-shard
replication with failover, and the runtime memory guard."""

from .timestore import (OnlineStore, ShardedOnlineStore,  # noqa: F401
                        StoreSnapshot, StoreState)
from .memest import MemoryGuard  # noqa: F401
from .replication import (FailoverController, PromotionRecord,  # noqa: F401
                          ReplicationLog, ReplicationManager,
                          cold_recover_shard, recover_preagg_shard)
