"""Online time-series store (unsharded and key-sharded), per-shard
replication with failover, the compact row codec (§7.1) and the runtime
memory guard."""

from .timestore import (OnlineStore, ShardedOnlineStore,  # noqa: F401
                        StoreSnapshot, StoreState)
from .encoding import (CompactRowCodec, SparkRowCodec,  # noqa: F401
                       row_size_compact, row_size_spark)
from .memest import MemoryGuard, estimate_memory  # noqa: F401
from .replication import (FailoverController, PromotionRecord,  # noqa: F401
                          ReplicationLog, ReplicationManager,
                          cold_recover_shard, recover_preagg_shard)
