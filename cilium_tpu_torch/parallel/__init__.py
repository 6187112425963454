"""Mesh/sharding: how the verdict dataplane scales over devices.

Port of ``cilium_tpu/parallel/``.  The reference scales per-packet work
across CPUs/NICs (per-CPU BPF maps, RSS) and across nodes via kvstore
replication.  Here the analogs are:
  * ``dp`` mesh axis — the packet batch axis (reported; each shard's
    step runs whole on its column's first device);
  * ``ep`` mesh axis — the stacked per-endpoint policy tables shard
    across devices, one slice + fault domain per shard
    (``sharded.ShardedDatapath``);
  * control-plane replication (kvstore) stays host-side.

``specs.py`` is the canonical placement registry for every device
table leaf; ``sharded.py`` is the sharded dataplane with per-shard
supervisors and partial-mesh survival.
"""

from .mesh import (DP_AXIS, EP_AXIS, batch_sharding, ep_submesh,
                   make_mesh, packed_batch_sharding, replicate,
                   shard_batch, table_sharding)
from .sharded import (ShardedDatapath, ShardedServingLane,
                      ShardedTableManager, ShardedTicket, global_slot,
                      local_slot, shard_of_slot)
