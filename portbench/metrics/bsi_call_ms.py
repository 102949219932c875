"""Host time a request in the port's BSI entry points: the totals of its
``bsi.compare`` (``compare`` and ``compare_resident``) and ``bsi.sum`` spans
inside the window, over the requests completed there. None where the port
has neither span."""


def read(r):
    parts = [r.per_request_ms(name) for name in ("bsi.compare", "bsi.sum")]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None)
