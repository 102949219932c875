"""From the harness's first line to the window's open: imports, the CUDA
context, the drawn data, the port's load, the kernels' build where the
checkout has none yet, and the warm-up."""


def read(r):
    return r.setup_s
