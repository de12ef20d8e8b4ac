"""yalla_tpu_torch: the PyTorch/CUDA port of yalla_tpu.

A second package beside ``yalla_tpu`` (the JAX reference it is tested
against), with the same module layout and names.  Plain tensor code is
PyTorch; every TPU kernel on a ported path is a hand-written CUDA kernel
for Hopper (``csrc/``), built at first use by ``_build.py``.  A kernel
wrapper launches its kernel for CUDA tensors and runs its plain torch
version for CPU tensors.  This package never imports JAX.
"""

from .dtypes import Float3, make_pt
from .solvers import (GabrielEngine, GenericForce, GridEngine, LatticeEngine,
                      SimulationError, Solution, TileEngine,
                      friction_on_background, friction_w_neighbour,
                      heun_step, heun_steps)

__all__ = ["Float3", "make_pt", "GabrielEngine", "GenericForce",
           "GridEngine", "LatticeEngine", "SimulationError", "Solution",
           "TileEngine", "friction_on_background", "friction_w_neighbour",
           "heun_step", "heun_steps"]
