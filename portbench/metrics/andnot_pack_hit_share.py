"""Hits of the n-way andnot's subtrahend lookups in the port's resident
pack cache (``store.PACK_CACHE.stats()["kinds"]["andnot"]``) over those
lookups inside the window. None where the port counts no such kind."""


def read(r):
    after = r.pack_after.get("kinds", {}).get("andnot")
    if after is None:
        return None
    before = r.pack_before.get("kinds", {}).get("andnot", {"hits": 0, "misses": 0})
    hits = after["hits"] - before["hits"]
    misses = after["misses"] - before["misses"]
    if hits + misses <= 0:
        return None
    return hits / (hits + misses) * 100.0
