"""The port's layers import downward only.

The Heun derivative the integrators share lives in ``ops/common.py``
(the derivative, the momentum fix, the mean velocity, the flag folds),
below ``solvers``, which imports the engines and the lattice integrator.
No module under ``yalla_tpu_torch/ops/`` and neither sharded integrator
(``parallel/spmd.py``, ``parallel/lattice_spmd.py``) may import
``solvers``, at module level or inside a function: that import would be
a cycle held apart only by its place in a function body.
"""
import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "yalla_tpu_torch"
LOWER = sorted(str(p.relative_to(PKG)) for p in (PKG / "ops").glob("*.py")) \
    + ["parallel/spmd.py", "parallel/lattice_spmd.py"]


def imported_modules(tree):
    """Every module an ``import`` or ``from ... import`` of ``tree``
    names, with the names a ``from`` imports as modules."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            yield base
            yield from (f"{base}.{a.name}" if base else a.name
                        for a in node.names)


def test_the_layers_are_listed():
    assert "ops/common.py" in LOWER and "ops/lattice_xla.py" in LOWER


@pytest.mark.parametrize("module", LOWER)
def test_lower_layer_does_not_import_solvers(module):
    tree = ast.parse((PKG / module).read_text(), module)
    bad = [m for m in imported_modules(tree)
           if "solvers" in m.split(".")]
    assert not bad, f"{module} imports {bad}"
