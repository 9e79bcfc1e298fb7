from . import mesh, shard
