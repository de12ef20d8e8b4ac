"""Shared test helpers, mirroring the reference's minunit fixture
(``/root/reference/tests/minunit.cuh``)."""
import numpy as np


def isclose(a, b):
    """The reference tolerance: atol 1e-6 + rtol 1e-2 (minunit.cuh:37)."""
    return np.all(np.abs(np.asarray(a) - np.asarray(b))
                  <= 1e-6 + 1e-2 * np.abs(np.asarray(b)))


def center_of_mass(points):
    """Mean position over active points (minunit.cuh:40-53)."""
    h = points.copy_to_host()
    n = points.h_n
    return (float(np.mean(h.x[:n])), float(np.mean(h.y[:n])),
            float(np.mean(h.z[:n])))


def self_is_total_less(spans, name, children):
    """Whether the span ``name``'s self seconds are its wall seconds less
    the wall seconds of ``children``: in a table where each of them opens
    only inside ``name``, they are its only child spans."""
    _, total, own = spans[name]
    rest = total - sum(spans[k][1] for k in children)
    return abs(own - rest) <= 1e-9 + 1e-9 * abs(total)
