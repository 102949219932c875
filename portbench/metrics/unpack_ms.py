"""Host time a request in the port's ``store.unpack_to_bitmap`` (its
``rb_tpu_host_op_seconds`` timer), the result words back into
containers."""


def read(r):
    return r.per_request_ms("store.unpack_to_bitmap")
