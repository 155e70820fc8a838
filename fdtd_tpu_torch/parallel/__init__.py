"""Spatial sharding (``--shard ZxY``): an in-process device mesh whose
shards exchange halo planes by tensor copies (:mod:`.mesh`), the sharded
torch step (:mod:`.sharded_step`) and the per-shard Hopper kernels
(:mod:`.sharded_fast`)."""
