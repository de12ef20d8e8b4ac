"""The port's ``mesh.py`` against the JAX package's, on the CPU.

Mirrors of ``tests/test_mesh.py`` (ref test_mesh.cu) on the port with the
same assertions (transforms against analytic bounds, torus inclusion
against the analytic ring distance, the Chamfer distance 0 and 0.1 after
``grow_normally(0.1)``, the write round trip), and the port held against
the JAX package: ``Mesh.test_exclusion_many`` equal point for point on
the teapot example at 4,000 points (the native library's test, and the numpy
form the port falls back to without it), and ``shape_comparison`` within
rtol 1e-5 (the two packages sum the nearest-point distances in another
order).
"""
import math
import os

import numpy as np
import pytest
import torch

from helpers import isclose
from yalla_tpu.mesh import Mesh as JMesh
from yalla_tpu.mesh import shape_comparison as j_shape_comparison
from yalla_tpu_torch import Float3, Solution, _native
from yalla_tpu_torch import mesh as M
from yalla_tpu_torch.inits import random_cuboid
from yalla_tpu_torch.mesh import (Mesh, shape_comparison,
                                  shape_comparison_points_to_points)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
TORUS = os.path.join(HERE, "torus.vtk")
TEAPOT = os.path.join(os.path.dirname(HERE), "examples", "teapot.vtk")


def _cuboid_points(n_max, dist, lo, hi, seed):
    points = Solution(Float3, n_max, solver="grid", device="cpu")
    random_cuboid(dist, lo, hi, points, rng=np.random.default_rng(seed))
    n = points.h_n
    return points, np.stack([points.h_X.x[:n], points.h_X.y[:n],
                             points.h_X.z[:n]], 1).astype(np.float64)


def test_mesh_transformations():
    mesh = Mesh(TORUS)
    assert isclose(mesh.get_minimum(), [-1.5, -1.5, -0.5])
    assert isclose(mesh.get_maximum(), [1.5, 1.5, 0.5])
    mesh.translate((1, 0, 0))
    assert isclose(mesh.get_minimum(), [-0.5, -1.5, -0.5])
    assert isclose(mesh.get_maximum(), [2.5, 1.5, 0.5])
    mesh.translate((-1, 0, 0))
    mesh.rotate(0, math.pi / 2, 0)
    assert isclose(mesh.get_minimum(), [-0.5, -1.5, -1.5])
    assert isclose(mesh.get_maximum(), [0.5, 1.5, 1.5])
    mesh.rotate(0, -math.pi / 2, 0)
    mesh.rescale(2)
    assert isclose(mesh.get_minimum(), [-3, -3, -1])
    assert isclose(mesh.get_maximum(), [3, 3, 1])
    mesh.rescale(0.5)
    mesh.grow_normally(0.1)
    assert isclose(mesh.get_minimum(), [-1.6, -1.6, -0.6])
    assert isclose(mesh.get_maximum(), [1.6, 1.6, 0.6])
    # every transform as the JAX package's, on the teapot
    t, j = Mesh(TEAPOT), JMesh(TEAPOT)
    np.testing.assert_array_equal(t.triangles, j.triangles)
    for m in (t, j):
        m.rotate(0.3, -0.2, 0.7)
        m.translate((0.5, -1.0, 2.0))
        m.rescale(1.5)
        m.grow_normally(0.05, boundary=True)
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.facet_normals(), j.facet_normals())
    np.testing.assert_array_equal(t.facet_centroids(), j.facet_centroids())


def test_mesh_exclusion_on_the_torus():
    _, pts = _cuboid_points(500, 0.35, (-1.5, -1.5, -0.5), (1.5, 1.5, 0.5),
                            seed=5)
    out = Mesh(TORUS).test_exclusion_many(pts)
    dist_from_ring = np.sqrt(
        (1 - np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)) ** 2 + pts[:, 2] ** 2)
    sel = np.abs(dist_from_ring - 0.5) >= 0.01  # tolerance for mesh facets
    assert np.array_equal((dist_from_ring >= 0.5)[sel], out[sel])
    assert Mesh(TORUS).test_exclusion((0.0, 0.0, 0.0))
    assert not Mesh(TORUS).test_exclusion((1.0, 0.0, 0.0))


@pytest.mark.parametrize("native", [True, False])
def test_mesh_exclusion_matches_jax_on_the_teapot(native, monkeypatch):
    """4,000 points of the teapot example's cuboid (its spacing at that
    count): the port's test, the native library's or the numpy form,
    equal to the JAX package's at every point."""
    mesh, jmesh = Mesh(TEAPOT), JMesh(TEAPOT)
    _, pts = _cuboid_points(4000, 0.125 * (70000 / 4000) ** (1 / 3),
                            mesh.get_minimum(), mesh.get_maximum(), seed=0)
    assert 2000 < len(pts) <= 4000
    if native:
        assert _native.get_lib() is not None
    else:
        monkeypatch.setattr(_native, "test_exclusion", lambda *a: None)
        monkeypatch.setattr(M, "NUMPY_PAIRS", 700 * len(mesh.triangles))
    got = mesh.test_exclusion_many(pts)
    want = jmesh.test_exclusion_many(pts)
    assert got.dtype == bool and got.shape == (len(pts),)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(pts)


def test_shape_comparison_on_the_torus():
    mesh = Mesh(TORUS)
    n = len(mesh.vertices)
    points = Solution(Float3, n, solver="grid", device="cpu")
    points.h_X.x[:n] = mesh.vertices[:, 0]
    points.h_X.y[:n] = mesh.vertices[:, 1]
    points.h_X.z[:n] = mesh.vertices[:, 2]
    points.copy_to_device()
    assert isclose(mesh.shape_comparison_mesh_to_points(points), 0.0)
    mesh.grow_normally(0.1)
    assert isclose(mesh.shape_comparison_mesh_to_points(points), 0.1)


@pytest.mark.parametrize("n1,n2", [(3000, 2000), (257, 700)])
def test_shape_comparison_matches_jax(n1, n2):
    """Two clouds of the teapot's box, more rows than active points (the
    rows past the counts must not count), against the JAX package's."""
    mesh = Mesh(TEAPOT)
    lo, hi = mesh.get_minimum(), mesh.get_maximum()
    g = np.random.default_rng(4)
    a = g.uniform(lo, hi, (n1 + 40, 3)).astype(np.float32)
    b = g.uniform(lo, hi, (n2 + 13, 3)).astype(np.float32)
    got = shape_comparison(a, n1, b, n2, device="cpu")
    want = j_shape_comparison(a, n1, b, n2)
    assert got == pytest.approx(want, rel=1e-5)
    # a tensor on the CPU gives the same (its device wins over the
    # default), and the blocks cover every row
    assert shape_comparison(torch.as_tensor(a), n1, torch.as_tensor(b),
                            n2) == got
    d = M._min_dists(torch.as_tensor(a[:n1]), torch.as_tensor(b), n2)
    full = np.sqrt(((a[:n1, None, :].astype(np.float64)
                     - b[None, :n2, :]) ** 2).sum(2)).min(1)
    np.testing.assert_allclose(d.numpy(), full, rtol=1e-5, atol=1e-6)


def test_shape_comparison_defaults_to_the_card():
    """Host arrays go to the card unless the caller names the CPU; without
    a GPU that raises, as the port's other entry points do."""
    a = np.random.default_rng(5).uniform(0, 1, (50, 3)).astype(np.float32)
    if torch.cuda.is_available():
        assert shape_comparison(a, 50, a, 50) == 0.0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shape_comparison(a, 50, a, 50)
    assert shape_comparison(a, 50, a, 50, device="cpu") == 0.0


def test_shape_comparison_points_to_points():
    t1, _ = _cuboid_points(600, 0.4, (0, 0, 0), (2, 2, 2), seed=1)
    t2, _ = _cuboid_points(600, 0.4, (0, 0, 0), (2, 2, 2), seed=2)
    got = shape_comparison_points_to_points(t1, t2)
    h1, h2 = t1.h_X, t2.h_X
    a = np.stack([h1.x, h1.y, h1.z], 1)
    b = np.stack([h2.x, h2.y, h2.z], 1)
    assert got == pytest.approx(j_shape_comparison(a, t1.h_n, b, t2.h_n),
                                rel=1e-5)
    assert shape_comparison_points_to_points(t1, t1) == 0.0


def test_mesh_write_roundtrip(tmp_path):
    mesh = Mesh(TORUS)
    mesh.write_vtk("torus_copy", str(tmp_path) + "/")
    again = Mesh(str(tmp_path) + "/torus_copy.mesh.vtk")
    assert len(again.triangles) == len(mesh.triangles)
    assert isclose(again.get_minimum(), mesh.get_minimum())
    assert isclose(again.get_maximum(), mesh.get_maximum())
