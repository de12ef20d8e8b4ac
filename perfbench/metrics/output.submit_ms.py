"""Host milliseconds per file that the loop spends in the writer: inside
``write_frame`` for each file queued in the traced window, plus the
window's final ``drain``, spread over the files."""


def read(ctx):
    spans = ctx.loop.spans
    files = len(spans.get("write_frame", ()))
    if ctx.trace is None or not files:
        return None
    return 1e3 * (sum(spans["write_frame"])
                  + sum(spans.get("drain", ()))) / files
