"""Scale-out of the port: batched multi-sequence fusion (batch.py) and one
surfel map sharded over the surfel axis of a process group (shard.py)."""
