from . import container, roaring_array, roaring

__all__ = ["container", "roaring_array", "roaring"]
