"""Runnable model scripts of the port (``python3 -m
yalla_tpu_torch.examples.<name>``), counterparts of ``examples/*.py``.

Each runs on the card unless the command line asks for the CPU
(``--device cpu``); each writes ``output/<name>_<t>.vtk`` in the current
directory.  ``EXAMPLES`` names them all (``branching`` is the flagship's
frame loop, with its own command line).

The examples with randoms or a schedule of steps (sorting, sorting_prot,
intercalation, passive_growth, lineage_tracing,
model_features_sequential_addition, growth_w_wall,
intercalation_w_gradient) share one shape beside ``setup(device)`` and
``main``:

* ``start(cells, n_steps=None)``: what a run carries beside its cells, a
  ``types.SimpleNamespace`` with ``t``, the index of the next step, and
  the example's own generator, links or lineage;
* ``draw(cells, state, generator)``: the randoms that step ``state.t``
  takes, made from ``generator`` (None where it takes none);
* ``step(cells, state, draws=None)``: step ``state.t``, with ``draws``
  where given (a test's or another device's), else from the run's own
  generators; it advances ``state.t``;
* ``run(cells, n_steps=None)``: the steps with their frames (the
  module's published count by default); returns the run's state."""

EXAMPLES = (
    "apical_constriction", "bending", "branching",
    "epithelia_double_polarity", "epithelium", "gradient", "growth_w_wall",
    "intercalation", "intercalation_w_gradient", "lineage_tracing",
    "migration", "model_features_sequential_addition", "passive_growth",
    "polarization", "random_walk", "sorting", "sorting_prot", "springs",
    "teapot", "turing", "turing_w_noise", "wnt", "write_vtk_w_mask")


def device_arg(argv, default="cuda"):
    """The value of ``--device`` in ``argv``, else ``default``."""
    if "--device" in argv:
        return argv[argv.index("--device") + 1]
    return default


def steps_arg(argv, default):
    """The first positional argument of ``argv`` (past the program's
    name) as an int, else ``default``."""
    args = [a for k, a in enumerate(argv[1:], 1)
            if not a.startswith("--") and argv[k - 1] != "--device"]
    return int(args[0]) if args else default
