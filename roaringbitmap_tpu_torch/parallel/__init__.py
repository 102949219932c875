from . import aggregation, store

__all__ = ["aggregation", "store"]
