"""setup_s: seconds from the run's process start to the window's first timed
dispatch: imports, the split and weights made from the seed, the kernels
loaded (built on a first run), the graphs captured and warmed (host clock)."""


def read(r):
    return r["setup_s"]
