"""Host time a request in building packs (``store.PACK_CACHE``'s misses and
the layouts derived from a pack): the self time of the ``pack.*`` build
stages, the transpose, the payload, the copy to the card, the expansion and
the padded and bucketed layouts. The wait for the overlap lane is left out.
Self time, so the copy and expansion that a padded layout triggers inside
its own stage count once."""

STAGES = ("pack.key_plan", "pack.group_tables", "pack.payload_build", "pack.ship",
          "pack.device_expand", "pack.padded_build", "pack.bucket_build")


def read(r):
    seen = [s for s in STAGES if "self_s" in r.timings_after.get(s, {})]
    if not seen or r.completed <= 0:
        return None
    secs = sum(r.timings_after[s]["self_s"] - r.timings_before.get(s, {}).get("self_s", 0.0)
               for s in seen)
    return secs / r.completed * 1e3
