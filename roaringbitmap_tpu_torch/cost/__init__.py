"""Pricing authorities.

Counterpart of ``roaringbitmap_tpu/cost/``. The port carries one
authority so far: ``fusion`` (``FusionBatchModel``, ``MODEL``), the fusion
executor's batch-vs-solo window curves. The columnar engine's three-way
model lives with its engine (``columnar/costmodel.py``). The JAX
package's facade over all its authorities, the hedge and window-autotune
pricing and the refit from the outcome ledger wait for the serving and
observability tiers.
"""

from . import fusion

__all__ = ["fusion"]
