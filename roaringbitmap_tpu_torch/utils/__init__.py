from . import bits

__all__ = ["bits"]
