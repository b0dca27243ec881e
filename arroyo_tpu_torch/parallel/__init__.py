"""Key-space sharding (the port's copy of arroyo_tpu/parallel): a mesh of
key shards over device slots and the sharded window aggregate over it."""

from .mesh import KEY_AXIS, Mesh, all_to_all, can_make, exchange, make_mesh  # noqa: F401
from .sharded_agg import ShardedAggregator  # noqa: F401
