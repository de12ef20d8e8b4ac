"""Cell-steps a second: the live cells summed over every Heun step of the
window (a frame's substeps counted at the frame's starting count), over
the window's wall seconds, read after the device finished."""


def read(ctx):
    if ctx.window is None:
        return None
    return ctx.window.cell_steps / ctx.window.seconds
