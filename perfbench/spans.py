"""The program's own spans and counters, as the per-layer readers in
``metrics/`` take them: the table of ``yalla_tpu_torch.utils.profiling``,
which the program fills while the traced window runs under
``torch.profiler`` (and, for its ``setup.*`` spans, in the set-up).  A
span is ``(count, total seconds, self seconds)``; "per step" is per
``integrator.heun_step`` span."""


def table():
    """``(spans, counters)`` of the program, or None where it keeps no
    such table."""
    try:
        from yalla_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    counters = getattr(profiling, "counters", None)
    if spans is None or counters is None:
        return None
    return spans(), counters()


def read_table(fn):
    """``fn(spans, counters)``; None where the program keeps no table, or
    where it lacks a span or counter that ``fn`` reads, or a count that
    ``fn`` divides by is 0."""
    t = table()
    if t is None:
        return None
    try:
        return fn(*t)
    except (KeyError, ZeroDivisionError):
        return None


def steps(spans):
    """The Heun steps the table holds."""
    return spans["integrator.heun_step"][0]
