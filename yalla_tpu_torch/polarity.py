"""Polarity, main-path subset: the Cartesian bending fast path.

Counterpart of ``yalla_tpu/polarity.py`` (``_angles``,
``polarity_precompute3``, ``bending_force_cart``, ``bending_post_pair``).
Polarity is a unit vector in spherical coordinates, 0 <= theta < pi,
-pi <= phi <= pi, stored as two Pt fields.  The pair body reads only the
per-cell unit vector (three derived channels); the angular gradient is
accumulated as a Cartesian vector and converted to (theta, phi) once per
cell after the pair pass.
"""
from __future__ import annotations

import torch

__all__ = ["polarity_precompute3", "bending_force_cart", "bending_post_pair"]

DEFAULT_AXIS = ("theta", "phi")


def _angles(p, axis):
    return getattr(p, axis[0]), getattr(p, axis[1])


def polarity_precompute3(X, n, axis=DEFAULT_AXIS, prefix="p"):
    """Per-cell polarity unit vector {px, py, pz} as derived fields (the
    ``precompute`` hook of the solvers)."""
    th, ph = _angles(X, axis)
    st = torch.sin(th)
    return {prefix + "x": st * torch.cos(ph), prefix + "y": st * torch.sin(ph),
            prefix + "z": torch.cos(th)}


def bending_force_cart(Xi, r, dist, p="p", inv=None):
    """Bending resistance (ref polarity.cuh:72-94) on precomputed polarity
    vectors, with the angular gradient left in Cartesian form.

    Returns ``(fx, fy, fz, gx, gy, gz)``: the positional force and the
    pair's contribution to ``G_i = sum_j (-prod_i) * r_hat``, which
    ``bending_post_pair`` converts per cell."""
    pxi, pyi, pzi = (getattr(Xi, p + f) for f in ("x", "y", "z"))
    rpx = getattr(r, p + "x")
    rpy = getattr(r, p + "y")
    rpz = getattr(r, p + "z")
    if inv is None:
        inv = 1.0 / dist
    prodi = (pxi * r.x + pyi * r.y + pzi * r.z) * inv
    prodj = prodi - (rpx * r.x + rpy * r.y + rpz * r.z) * inv
    ai = prodi * inv
    aj = prodj * inv
    s1 = ai + aj
    s2 = ai * ai + aj * aj
    fx = s2 * r.x - s1 * pxi + aj * rpx
    fy = s2 * r.y - s1 * pyi + aj * rpy
    fz = s2 * r.z - s1 * pzi + aj * rpz
    t = -prodi * inv
    return fx, fy, fz, t * r.x, t * r.y, t * r.z


def bending_post_pair(F, aux, X, axis=DEFAULT_AXIS,
                      keys=("pg_x", "pg_y", "pg_z")):
    """Convert the accumulated Cartesian angular gradient ``G`` into the
    (theta, phi) force components, added onto F:

        F_theta = e_theta . G           e_theta = (ct cf, ct sf, -st)
        F_phi   = (e_phi . G) / sin t   e_phi   = (-sf, cf, 0)

    with the reference's |sin theta| > 1e-10 gimbal guard as a zero
    (polarity.cuh:56-58).  Consumes the three aux channels."""
    aux = dict(aux)
    Gx, Gy, Gz = (aux.pop(k) for k in keys)
    th, ph = _angles(X, axis)
    ct, st = torch.cos(th), torch.sin(th)
    cf, sf = torch.cos(ph), torch.sin(ph)
    safe = torch.abs(st) > 1e-10
    inv_st = torch.where(safe, 1.0 / torch.where(safe, st, 1.0), 0.0)
    dth = ct * (cf * Gx + sf * Gy) - st * Gz
    dph = (cf * Gy - sf * Gx) * inv_st
    return (F.replace(**{axis[0]: getattr(F, axis[0]) + dth,
                         axis[1]: getattr(F, axis[1]) + dph}), aux)
