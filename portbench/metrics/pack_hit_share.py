"""Hits of the port's resident pack cache (``store.PACK_CACHE``) over its
lookups inside the window."""


def read(r):
    hits = r.pack_after["hits"] - r.pack_before["hits"]
    misses = r.pack_after["misses"] - r.pack_before["misses"]
    if hits + misses <= 0:
        return None
    return hits / (hits + misses) * 100.0
