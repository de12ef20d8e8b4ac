"""The device force functors of the pair kernels, and the wrapper helpers
the lattice (K1), all-pairs (K3) and Gabriel lattice (K5) kernel wrappers
share.

The JAX kernels are force-generic because they trace any jnp force; a CUDA
kernel is compiled, so a force declares the device functor that implements
it, ``force.cuda_functor = (name, params)``, and a kernel wrapper refuses a
force without one on the GPU.  ``PAIR_FUNCTORS`` describes each functor of
``csrc/forces.cuh``: the C entry point of each kernel that implements it,
the friction it implements (the torch friction declares its name as
``friction.cuda_friction``), the Pt fields it reads (then old_v x y z), the
dF fields and aux channels it sums (then sum_f and sum_v x y z), the
parameter values it takes, and, for the all-pairs kernel, the i-points
each thread holds (``tile_rows``, its template parameter R there).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .common import split_force_output

__all__ = ["PAIR_FUNCTORS", "pair_functor", "require", "dF_type",
           "param_array", "unpack_sums"]

PAIR_FUNCTORS = {
    "branching": dict(
        entries={"lattice": "yalla_lattice_pair_branching",
                 "tile": "yalla_tile_pair_branching"},
        friction="friction_w_neighbour",
        fields=("x", "y", "z", "u", "v", "ctype", "px", "py", "pz"),
        dF=("x", "y", "z", "u", "v"),
        aux=("epi_nbs", "pg_x", "pg_y", "pg_z"),
        params=("r_max", "lam", "D_u", "D_v", "f_v", "f_u", "g_u", "m_u",
                "m_v", "s_u"),
        tile_rows=2),
    # examples/intercalation_w_gradient.py::force on the point fields and
    # the seven channels of polarity.polarity_precompute
    "intercalation_w_gradient": dict(
        entries={"lattice": "yalla_lattice_pair_intercalation_w_gradient"},
        friction="friction_w_neighbour",
        fields=("x", "y", "z", "w", "f", "ctype", "px", "py", "pz", "pcf",
                "psf", "pst", "psg"),
        dF=("x", "y", "z", "w", "f", "theta", "phi"),
        aux=("epi_nbs", "mes_nbs"),
        params=("r_max",)),
    "sorting_adhesion": dict(
        entries={"tile": "yalla_tile_pair_sorting"},
        friction="friction_w_neighbour",
        fields=("x", "y", "z", "ctype"),
        dF=("x", "y", "z"),
        aux=(),
        params=("r_max", "r_min"),
        tile_rows=4),
    "inits_relu": dict(
        entries={"tile": "yalla_tile_pair_inits_relu"},
        friction="friction_w_neighbour",
        fields=("x", "y", "z"),
        dF=("x", "y", "z"),
        aux=(),
        params=(),
        tile_rows=4),
    # the all-pairs examples (yalla_tpu_torch/examples); their forces
    # declare the example's module as the parameters' source
    "spring": dict(
        entries={"tile": "yalla_tile_pair_spring"},
        friction="friction_w_neighbour",
        fields=("x", "y", "z"),
        dF=("x", "y", "z"),
        aux=(),
        params=("L_0",),
        tile_rows=4),
    "gradient_diffusion": dict(
        entries={"tile": "yalla_tile_pair_gradient_diffusion"},
        friction="friction_w_neighbour",
        fields=("x", "y", "z", "w"),
        dF=("w",),
        aux=(),
        params=("r_max", "D", "SOURCE"),
        tile_rows=4),
    "bending_layer": dict(
        entries={"tile": "yalla_tile_pair_bending_layer"},
        friction="friction_w_neighbour",
        fields=("x", "y", "z", "theta", "phi"),
        dF=("x", "y", "z", "theta", "phi"),
        aux=(),
        params=("r_max", "bend_weight"),
        tile_rows=1),
    "relu_migration": dict(
        entries={"tile": "yalla_tile_pair_relu_migration"},
        friction="friction_w_neighbour",
        fields=("x", "y", "z", "theta", "phi"),
        dF=("x", "y", "z"),
        aux=(),
        params=("r_max",),
        tile_rows=1),
    "wnt_diffusion": dict(
        entries={"tile": "yalla_tile_pair_wnt_diffusion"},
        friction="friction_w_neighbour",
        fields=("x", "y", "z", "w", "theta", "phi"),
        dF=("w", "theta", "phi"),
        aux=(),
        params=("r_max", "D", "SOURCE"),
        tile_rows=2),
    "growth_w_wall_relu": dict(
        entries={"gabriel": "yalla_gabriel_pair_wall_relu"},
        friction="wall_friction",
        fields=("x", "y", "z"),
        dF=("x", "y", "z"),
        aux=(),
        params=("r_max", "wall")),
}


def pair_functor(pw_int, pw_friction, kernel, plain_path):
    """``(spec, params)`` of the force's functor in ``kernel`` ("lattice",
    "tile" or "gabriel"); raises if the kernel cannot run this force and
    friction.
    ``plain_path`` names the plain path that runs any force."""
    functor = getattr(pw_int, "cuda_functor", None)
    if functor is None or functor[0] not in PAIR_FUNCTORS:
        raise ValueError(
            f"{kernel} pair kernel: the force declares no CUDA functor "
            f"(force.cuda_functor); only forces with a device functor in "
            f"csrc/forces.cuh run on the GPU; {plain_path} runs any force")
    spec, params = PAIR_FUNCTORS[functor[0]], functor[1]
    if kernel not in spec["entries"]:
        raise ValueError(f"{kernel} pair kernel: the CUDA functor "
                         f"{functor[0]!r} is not built into this kernel")
    if getattr(pw_friction, "cuda_friction", None) != spec["friction"]:
        raise ValueError(f"{kernel} pair kernel: the CUDA functor "
                         f"{functor[0]!r} implements the friction "
                         f"{spec['friction']} only; {plain_path} runs any "
                         f"friction")
    if functor[0] == "branching" and getattr(params, "r_max", 1.0) != 1.0:
        raise ValueError(f"{kernel} pair kernel: the branching functor "
                         f"derives mes_nbs from the friction sum, which "
                         f"needs r_max == 1")
    return spec, params


def require(t, shape, dtype, device, what):
    """``t`` if it is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``; raises otherwise."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} {shape} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t


@functools.lru_cache(maxsize=16)
def dF_type(pw_int, pt_type):
    """The force's dF point type and aux keys, from one scalar probe on
    the CPU (memoised: the probe costs ~0.5 ms of host time per pass)."""
    one = torch.ones(1)
    Xi = pt_type(*([one] * len(pt_type._fields)))
    dF, aux = split_force_output(pw_int(Xi, Xi - Xi, one, one, one))
    return type(dF), tuple(aux)


def param_array(spec, params):
    """The functor's parameters as a ctypes float array."""
    return (ctypes.c_float * len(spec["params"]))(
        *[float(getattr(params, k)) for k in spec["params"]])


def unpack_sums(rows, spec, pw_int, pt_type):
    """``(F, sum_f, sum_v, aux)`` from a kernel's output rows (the dF
    fields, the aux channels, sum_f, sum_v x y z); dF fields the functor
    does not sum are zero."""
    d_type, aux_keys = dF_type(pw_int, pt_type)
    assert set(aux_keys) == set(spec["aux"]), aux_keys
    zero = torch.zeros_like(rows[0])
    k = len(spec["dF"])
    F = d_type(**{f: rows[spec["dF"].index(f)] if f in spec["dF"] else zero
                  for f in d_type._fields})
    aux = {a: rows[k + i] for i, a in enumerate(spec["aux"])}
    m = k + len(spec["aux"])
    return F, rows[m], (rows[m + 1], rows[m + 2], rows[m + 3]), aux
