"""Multi-device placement: the mesh (mesh.py), corpus sharding (shard.py),
sharded and replicated indexes with fan-out search (search.py), elastic
rebuilds (elastic.py) and the host-side result aggregator
(aggregator.py)."""
