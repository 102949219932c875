from . import aggregation, batch, sharding, store

__all__ = ["aggregation", "batch", "sharding", "store"]
