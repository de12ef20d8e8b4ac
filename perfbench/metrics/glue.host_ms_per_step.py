"""Host milliseconds of a Heun step (``integrator.heun_step``): the issue
of its glue, the lattice builds and the kernel wrappers, over the
steps."""
from perfbench.spans import read_table, steps


def read(ctx):
    return read_table(lambda s, c: 1e3 * s["integrator.heun_step"][1]
                      / steps(s))
