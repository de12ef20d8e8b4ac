"""Checkpointing and profiling utilities (counterpart of
``yalla_tpu/utils``; its compile cache has no counterpart: nothing here
is compiled ahead of time but the kernels, which ``_build.py`` caches)."""
from .checkpoint import load_solution, save_solution
from .profiling import StepTimer, trace

__all__ = ["save_solution", "load_solution", "StepTimer", "trace"]
