"""The found sets the port's BSI took up as they lay on the device (its
``bsi.found.resident`` span) over those it took up at all, the host
marshals of bitmap found sets (``bsi.found.marshal``) included, inside the
window. None where the port opened neither span."""


def read(r):
    resident, _ = r.timer("bsi.found.resident")
    marshal, _ = r.timer("bsi.found.marshal")
    if resident + marshal <= 0:
        return None
    return resident / (resident + marshal) * 100.0
