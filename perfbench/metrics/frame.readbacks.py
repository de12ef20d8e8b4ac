"""Synchronizing host readbacks of one frame and its flags, as
``torch.cuda.set_sync_debug_mode`` reports them."""


def read(ctx):
    return ctx.loop.counts.get("readbacks_per_frame")
