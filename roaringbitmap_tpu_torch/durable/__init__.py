"""Durable epochs: the on-disk half of the epoch store.

Counterpart of ``roaringbitmap_tpu/durable/``; an artifact written by
either package recovers in the other.

* :mod:`.format` — the frozen mmap corpus artifact (zero-copy portable
  payloads + key directory; serves reads with no parse step), byte for
  byte the JAX package's for the same corpus.
* :mod:`.store` — atomic priced persistence of published epochs
  (tmp-dir + fsync + rename, manifest-last with sha256; fault site
  ``durable.persist``; the ``durable.persist`` decision under the epoch
  cost authority).
* :mod:`.recovery` — crash recovery and warm restart: newest complete
  manifest wins, torn artifacts are skipped and surfaced, pack-cache
  working sets re-admit from the map onto the device.
"""

from .format import MappedCorpus, write_corpus
from .recovery import Recovery, recover
from .store import (
    DEFAULT_KEEP,
    PERSIST_OUTCOMES,
    PERSIST_STAGES,
    SCHEMA,
    DurableStore,
    current_store,
)

__all__ = [
    "DEFAULT_KEEP",
    "DurableStore",
    "MappedCorpus",
    "PERSIST_OUTCOMES",
    "PERSIST_STAGES",
    "Recovery",
    "SCHEMA",
    "current_store",
    "recover",
    "write_corpus",
]
