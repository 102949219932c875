"""The project-native rules, two tiers. Importing this package registers
every checker: lexical rules in ``core.CHECKERS`` (one file at a time),
contract/dataflow rules in ``core.CONTRACT_CHECKERS`` (whole-program,
over a ProjectContext). Add a module here (with ``@register`` or
``@register_contract``) to grow either set.

``trace-safety`` and ``use-after-donation`` have no counterpart: the
port has no jit to trace and donates no buffer (``index_copy_`` takes
the donated scatter's place)."""

# lexical tier (per-file)
from . import dtype  # noqa: F401
from . import exceptions  # noqa: F401
from . import locks  # noqa: F401
from . import metrics  # noqa: F401

# contract tier (whole-program)
from . import decision_contract  # noqa: F401
from . import epochpin  # noqa: F401
from . import fault_contract  # noqa: F401
from . import registry_contracts  # noqa: F401
