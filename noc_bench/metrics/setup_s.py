"""Process start to the first measured request: imports, the CUDA context,
loading (or at a checkout's first run building) the kernel, the fabric and
one warm-up request of the cell's own mix."""


def read(run):
    return run["setup_s"]
