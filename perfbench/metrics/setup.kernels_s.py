"""Seconds of the set-up that load the program's native code: the
``setup.kernels`` span (the CUDA kernels' hash, a build where needed,
the load) and the ``setup.native`` span (the VTK serializer's)."""
from perfbench.spans import read_table


def read(ctx):
    return read_table(lambda s, c: s["setup.kernels"][1]
                      + s.get("setup.native", (0, 0.0, 0.0))[1])
