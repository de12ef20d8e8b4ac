"""Device milliseconds per Heun step of every operation but the
hand-written pair and pour kernels (K1, K2): the eager glue of the
integrator, the forces and the growth."""

KERNELS = ("lattice_pair_kernel", "extras_pair_kernel", "pour_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.trace.steps:
        return None
    glue = sum(ctx.trace.per_op.values()) - ctx.op_seconds(KERNELS)
    return 1e3 * glue / ctx.trace.steps
