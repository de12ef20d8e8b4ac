"""Closed surface meshes for image-based models, and the Chamfer shape
comparison.

Counterpart of ``yalla_tpu/mesh.py`` (ref ``include/mesh.cuh``): read VTK
POLYDATA triangle meshes, transform them (translate, rotate, rescale,
grow_normally), test point inclusion by ray-triangle parity, and quantify
shape agreement with the symmetric Chamfer distance
(``shape_comparison``, the library's fitness metric, ref mesh.cuh:58-88).

The geometry of the mesh stays in host numpy (f64).  The inclusion test
runs in the native library (``_native``, the port's copy of the JAX
package's ``yt_test_exclusion``), with a vectorised numpy form where it is
not built.  The nearest-point distances of the Chamfer distance
(:func:`_min_dists`, the reference's tiled kernel mesh.cuh:27-56) are
blocked torch on the device of the points when they are tensors, else on
the ``device`` the caller names (the card by default).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import _native
from .dtypes import device_of

__all__ = ["Mesh", "shape_comparison", "shape_comparison_points_to_points"]

# rows of A a block of the distance matrix holds
MIN_DIST_BLOCK = 256
# (point, facet) pairs a chunk of the numpy inclusion test holds
NUMPY_PAIRS = 50_000_000


def _min_dists(A, B, n2):
    """min_j |A_i - B_j| over the first ``n2`` rows of B, for every row of
    A: f32 ``[n1, 3]`` and ``[m, 3]`` tensors on one device.  Blocked
    elementwise |a - b|^2 (exact in f32, as the JAX package computes it),
    ``MIN_DIST_BLOCK`` rows of A at a time, so only a
    ``[block, n2]`` tile is live."""
    Bn = B[:n2]
    out = torch.empty(A.shape[0], dtype=A.dtype, device=A.device)
    for s in range(0, A.shape[0], MIN_DIST_BLOCK):
        diff = A[s:s + MIN_DIST_BLOCK, None, :] - Bn[None, :, :]
        d2 = (diff * diff).sum(2)
        out[s:s + MIN_DIST_BLOCK] = torch.sqrt(d2.min(1).values)
    return out


def _as_points(xyz, device):
    if torch.is_tensor(xyz):
        return xyz.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(xyz, np.float32), device=device)


def shape_comparison(xyz1, n1, xyz2, n2, device="cuda"):
    """Symmetric Chamfer distance: the mean nearest-point distance both
    ways over the first ``n1`` rows of ``xyz1`` and ``n2`` of ``xyz2``
    (ref mesh.cuh:58-79).  Arrays or tensors ``[*, 3]``, computed on the
    device of ``xyz2`` if it is a tensor, else of ``xyz1`` if it is one,
    else on ``device`` (the card unless the caller asks for the CPU)."""
    device = next((t.device for t in (xyz2, xyz1) if torch.is_tensor(t)),
                  None) or device_of(device, "shape_comparison")
    A = _as_points(xyz1, device)[:n1]
    B = _as_points(xyz2, device)[:n2]
    mean12 = _min_dists(A, B, n2).sum() / n1
    mean21 = _min_dists(B, A, n1).sum() / n2
    return float((mean12 + mean21) / 2)


def _xyz(points):
    """The active positions of a Solution's device state, ``[n, 3]``."""
    n = points.get_d_n()
    return torch.stack([points.d_X.x[:n], points.d_X.y[:n],
                        points.d_X.z[:n]], 1)


def shape_comparison_points_to_points(points1, points2):
    """The Chamfer distance between two Solutions' active points, on the
    device of ``points2``."""
    return shape_comparison(_xyz(points1), points1.get_d_n(),
                            _xyz(points2), points2.get_d_n())


class Mesh:
    """Triangle mesh with transforms and inclusion tests
    (ref mesh.cuh:121-462)."""

    # the reference's fixed ray direction (mesh.cuh:390)
    _RAY_DIR = np.array([0.22788, 0.38849, 0.81499])

    def __init__(self, file_name=None):
        self.vertices = np.zeros((0, 3), np.float64)
        self.triangles = np.zeros((0, 3), np.int64)  # vertex indices
        if file_name is not None:
            self._read_vtk(file_name)

    # -- I/O ------------------------------------------------------------------
    def _read_vtk(self, file_name):
        with open(file_name) as f:
            lines = f.read().splitlines()
        i = 0
        while not (lines[i].split() and lines[i].split()[0] == "POINTS"):
            i += 1
        n_vertices = int(lines[i].split()[1])
        i += 1
        vals = []
        while len(vals) < 3 * n_vertices:
            vals.extend(float(v) for v in lines[i].split())
            i += 1
        self.vertices = np.asarray(vals, np.float64).reshape(n_vertices, 3)

        while not (lines[i].split()
                   and lines[i].split()[0] in ("POLYGONS", "CELLS")):
            i += 1
        n_facets = int(lines[i].split()[1])
        if n_facets % 2:
            raise ValueError(f"{file_name}: {n_facets} facets, the mesh "
                             f"cannot be closed (ref mesh.cuh:190)")
        i += 1
        tris = [tuple(int(v) for v in lines[i + k].split()[1:4])
                for k in range(n_facets)]
        self.triangles = np.asarray(tris, np.int64)

    def write_vtk(self, output_tag, output_dir="output/"):
        """Write facets as disconnected triangles (ref mesh.cuh:421-449)."""
        os.makedirs(output_dir, exist_ok=True)
        V = self.facet_vertices().reshape(-1, 3)
        nf = len(self.triangles)
        with open(f"{output_dir}{output_tag}.mesh.vtk", "w") as f:
            f.write("# vtk DataFile Version 3.0\n")
            f.write(f"{output_tag}.mesh\nASCII\nDATASET POLYDATA\n")
            f.write(f"\nPOINTS {3 * nf} float\n")
            np.savetxt(f, V, fmt="%.6g")
            f.write(f"\nPOLYGONS {nf} {4 * nf}\n")
            ids = np.arange(3 * nf).reshape(nf, 3)
            np.savetxt(f, np.hstack([np.full((nf, 1), 3), ids]), fmt="%d")

    # -- derived geometry ------------------------------------------------------
    def facet_vertices(self):
        """[n_facets, 3, 3]: the triangle corners."""
        return self.vertices[self.triangles]

    def facet_normals(self):
        V = self.facet_vertices()
        n = np.cross(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0])
        return n / np.linalg.norm(n, axis=1, keepdims=True)

    def facet_centroids(self):
        return self.facet_vertices().mean(axis=1)

    def get_minimum(self):
        return self.vertices.min(axis=0)

    def get_maximum(self):
        return self.vertices.max(axis=0)

    # -- transforms (ref mesh.cuh:243-377) --------------------------------------
    def translate(self, offset):
        self.vertices = self.vertices + np.asarray(offset, np.float64)

    def rescale(self, factor):
        self.vertices = self.vertices * factor

    def rotate(self, around_z, around_y, around_x):
        """Sequential rotations about z, then y, then x (ref
        mesh.cuh:257-333; same axis conventions)."""
        cz, sz = math.cos(around_z), math.sin(around_z)
        cy, sy = math.cos(around_y), math.sin(around_y)
        cx, sx = math.cos(around_x), math.sin(around_x)
        V = self.vertices
        x, y = V[:, 0].copy(), V[:, 1].copy()
        V[:, 0] = x * cz - y * sz
        V[:, 1] = x * sz + y * cz
        x, z = V[:, 0].copy(), V[:, 2].copy()
        V[:, 0] = x * cy - z * sy
        V[:, 2] = x * sy + z * cy
        y, z = V[:, 1].copy(), V[:, 2].copy()
        V[:, 1] = y * cx - z * sx
        V[:, 2] = y * sx + z * cx

    def grow_normally(self, amount, boundary=False):
        """Displace each vertex by ``amount`` along its mean facet normal;
        optionally pin x == 0 boundary vertices (ref mesh.cuh:349-377)."""
        normals = self.facet_normals()
        avg = np.zeros_like(self.vertices)
        for corner in range(3):
            np.add.at(avg, self.triangles[:, corner], normals)
        d = np.linalg.norm(avg, axis=1, keepdims=True)
        step = avg * (amount / d)
        if boundary:
            step[self.vertices[:, 0] == 0.0] = 0.0
        self.vertices = self.vertices + step

    # -- inclusion test (ref mesh.cuh:379-419) ------------------------------------
    def test_exclusion(self, point):
        """True if ``point`` lies OUTSIDE the closed mesh (an even number of
        ray-triangle intersections along a fixed direction)."""
        return bool(self.test_exclusion_many(
            np.asarray(point, np.float64).reshape(1, 3))[0])

    def test_exclusion_many(self, points):
        """The parity test of ``[n, 3]`` points: bool[n], True = outside.

        Runs in the native library (O(1) memory, OpenMP over the points);
        where it is not built, the numpy form below, which holds a
        [points, facets] block and so takes the points in chunks."""
        P0 = np.asarray(points, np.float64)
        V = self.facet_vertices()
        out = _native.test_exclusion(P0, V, self._RAY_DIR)
        if out is not None:
            return out
        chunk = max(1, NUMPY_PAIRS // max(len(V), 1))
        return np.concatenate(
            [self._exclusion_numpy(P0[i:i + chunk], V)
             for i in range(0, len(P0), chunk)] + [np.zeros(0, bool)])

    def _exclusion_numpy(self, P0, V):
        n = self.facet_normals()
        d = self._RAY_DIR
        # r = n.(V0 - P0) / n.d per (point, facet)
        num = np.einsum("fc,pfc->pf", n, V[None, :, 0] - P0[:, None])
        den = np.einsum("fc,c->f", n, d)[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            r = num / den
        PI = P0[:, None, :] + d[None, None, :] * r[:, :, None]
        u = V[:, 1] - V[:, 0]
        v = V[:, 2] - V[:, 0]
        w = PI - V[None, :, 0]
        uu = np.einsum("fc,fc->f", u, u)[None]
        uv = np.einsum("fc,fc->f", u, v)[None]
        vv = np.einsum("fc,fc->f", v, v)[None]
        wu = np.einsum("pfc,fc->pf", w, u)
        wv = np.einsum("pfc,fc->pf", w, v)
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = uv * uv - uu * vv
            s = (uv * wv - vv * wu) / denom
            t = (uv * wu - uu * wv) / denom
        hit = (r >= 0) & (s >= 0) & (s <= 1) & (t >= 0) & (s + t <= 1)
        return (hit.sum(axis=1) % 2) == 0

    # -- fitness metric -----------------------------------------------------------
    def shape_comparison_mesh_to_points(self, points):
        """The Chamfer distance between the mesh's vertices and a
        Solution's active points, on the points' device."""
        return shape_comparison(self.vertices, len(self.vertices),
                                _xyz(points), points.get_d_n())
