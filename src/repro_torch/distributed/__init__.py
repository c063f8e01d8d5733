"""Sharded search: the per-shard locals and merge (``sharding``) and the
pre-placed serving backend (``backend``).  Import the submodules
directly."""
