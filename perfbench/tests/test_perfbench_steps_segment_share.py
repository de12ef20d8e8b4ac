"""The reader of ``steps.segment_share``: the slot-order integrator's
segment replays over the traced window's pair passes, and nothing where
the program keeps no such counter."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import harness
from yalla_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[2]


def read(ctx):
    return harness.load_module(REPO / "perfbench" / "metrics"
                               / "steps.segment_share.py").read(ctx)


class Loop:
    """The steps loop's traced window: ``intervals`` intervals of
    ``steps`` steps, two states each standing for ``steps`` passes."""

    def __init__(self, intervals, steps):
        self.states = [(None, 100, steps)] * (2 * intervals)

    def pass_states(self):
        return self.states


def test_steps_segment_share_reads_replays_over_passes():
    ctx = SimpleNamespace(trace=None, loop=Loop(intervals=4, steps=11))
    with profiling.tracing():
        profiling.count("integrator.segment_replay", 2 * 11 * 4)
        assert read(ctx) == pytest.approx(1.0)
    with profiling.tracing():
        profiling.count("integrator.segment_replay", 2 * 11 * 3)
        assert read(ctx) == pytest.approx(0.75)


def test_steps_segment_share_none_without_its_counter_or_passes():
    # the program before the slot-order loop's segments (the parent's)
    with profiling.tracing():
        with profiling.span("integrator.heun_step"):
            pass
        assert read(SimpleNamespace(trace=None, loop=Loop(8, 11))) is None
    # an untraced run: no passes in a window
    with profiling.tracing():
        profiling.count("integrator.segment_replay", 4)
        assert read(SimpleNamespace(trace=None, loop=Loop(0, 11))) is None
