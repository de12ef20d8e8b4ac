"""Device operations (kernels, copies, fills) launched per Heun step in
the traced window: the host's issue load."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.steps:
        return None
    return sum(ctx.trace.launches.values()) / ctx.trace.steps
