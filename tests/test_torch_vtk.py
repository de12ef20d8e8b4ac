"""The port's VTK output and input (``vtkio.py``, with its own copy of the
native serializer), ``Property`` and the array checkpoints against the JAX
package.

Both packages are given the same numpy arrays, and every file the port
writes must hold the same bytes as the JAX package's: per-array
``write_*`` calls, ``write_frame``, synchronous and asynchronous.  An
asynchronous write snapshots what it will write when it is submitted:
mutating the state right after the call leaves the file as it was.
Mirrors ``tests/test_vtk.py`` and the checkpoint tests of
``tests/test_utils.py``.
"""
import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import isclose
from yalla_tpu import Property as JProperty, Solution as JSolution
from yalla_tpu import dtypes as jdt
from yalla_tpu.links import Links as JLinks
from yalla_tpu.utils import (load_solution as j_load_solution,
                             save_solution as j_save_solution)
from yalla_tpu.vtkio import Vtk_output as JVtk_output
from yalla_tpu_torch import Solution, _native, make_pt
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.links import Links
from yalla_tpu_torch.property import Property
from yalla_tpu_torch.utils import load_solution, save_solution
from yalla_tpu_torch.vtkio import Vtk_input, Vtk_output

torch.set_num_threads(2)

JPo_cell4 = jdt.make_pt("Po_cell4", "w", "theta", "phi")
Po_cell4 = make_pt("Po_cell4", "w", "theta", "phi")
N = 50


def scene(seed=42, n=N):
    """The same points, links and properties in both packages:
    ``{"jax": (points, links, int prop, float prop), "torch": (...)}``."""
    rng = np.random.default_rng(seed)
    fields = {f: rng.random(n).astype(np.float32) for f in "xyzw"}
    # values whose shortest decimal forms vary in length and exponent
    fields["x"][:4] = [0.0, -1.5e-7, 123456.79, 1e10]
    fields["theta"] = np.arccos(2 * rng.random(n) - 1).astype(np.float32)
    fields["phi"] = (rng.random(n) * 2 * math.pi - math.pi).astype(np.float32)
    fields["theta"][5] = fields["phi"][5] = 0.0     # the unset polarity
    ints = rng.integers(-2 ** 30, 2 ** 30, n)
    floats = rng.random(n).astype(np.float32)
    out = {}
    for name, S, P, L, pt, kw in (
            ("jax", JSolution, JProperty, JLinks, JPo_cell4, {}),
            ("torch", Solution, Property, Links, Po_cell4,
             dict(device="cpu"))):
        pts = S(pt, n, solver="tile", **kw)
        for f, a in fields.items():
            getattr(pts.h_X, f)[:n] = a
        pts.copy_to_device()
        links = L(3, **kw)
        links.h_a[:3] = [0, 1, 2]
        links.h_b[:3] = [3, 4, 45]
        links.copy_to_device()
        iprop = P(n, "intprop", np.int32, **kw)
        iprop.h_prop[:] = ints
        iprop.copy_to_device()
        fprop = P(n, "fprop", np.float32, **kw)
        fprop.h_prop[:] = floats
        fprop.copy_to_device()
        out[name] = (pts, links, iprop, fprop)
    return out


def per_array(out, pts, links, iprop, fprop, mask):
    out.write_positions(pts, mask=mask)
    out.write_links(links)
    out.write_polarity(pts)
    out.write_field(pts, "w")
    out.write_property(iprop)
    out.write_property(fprop)


def whole_frame(out, pts, links, iprop, fprop, mask):
    out.write_frame(pts, mask=mask, polarity=True, fields=("w",),
                    properties=(iprop, fprop))


def frame_with_tuples(out, pts, links, iprop, fprop, mask):
    d = iprop.d_prop
    out.write_frame(pts, mask=mask, fields=("w", "theta"),
                    properties=(("clone", d * 0 + 3, np.int32),
                                ("f", fprop.d_prop, np.float32)))


WRITERS = {"per_array": per_array, "write_frame": whole_frame,
           "write_frame_tuples": frame_with_tuples}


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("masked", ["all_points", "masked"])
@pytest.mark.parametrize("writer", list(WRITERS))
def test_files_match_jax_byte_for_byte(tmp_path, writer, masked, mode):
    s = scene()
    mask = (np.arange(N) % 5 != 0) if masked == "masked" else None
    for name, V in (("jax", JVtk_output), ("torch", Vtk_output)):
        with V("t", str(tmp_path / name), verbose=False,
               async_write=mode == "async") as out:
            for _ in range(2):      # two frames exercise the queue's order
                WRITERS[writer](out, *s[name], mask)
    for t in range(2):
        a = (tmp_path / "jax" / f"t_{t}.vtk").read_bytes()
        b = (tmp_path / "torch" / f"t_{t}.vtk").read_bytes()
        assert a == b, f"frame {t} differs from the JAX package's"
    assert b"POINTS %d float" % (40 if mask is not None else N) in b


def test_native_serializer_is_built_and_used(tmp_path):
    """The port builds its own copy of the serializer (g++ is present
    here), apart from the JAX package's."""
    lib = _native.get_lib()
    assert lib is not None
    import yalla_tpu._native as j_native
    assert lib is not j_native.get_lib()
    assert "_build" in lib._name and "yalla_tpu_torch" in lib._name
    # bytes-like views of the output buffers, for binary files
    assert bytes(_native.format_rows(np.array([[0.1, 2.0, -3e-5]],
                                              np.float32))) \
        == b"0.1 2 -3e-05\n"
    assert bytes(_native.format_ints(np.array([7, -8]))) == b"7\n-8\n"
    assert bytes(_native.format_vertices(2)) == b"1 0\n1 1\n"
    assert bytes(_native.format_lines([0, 2], [1, 3])) == b"2 0 1\n2 2 3\n"
    assert list(_native.parse_doubles("1.5 2\n-3e2", 8)) == [1.5, 2.0, -300.0]


def test_native_parse_floats_matches_jax(monkeypatch):
    """``tests/test_utils.py::test_native_io_layer``'s parse: the port's
    ``parse_floats`` on the text of its own ``format_rows`` equals the JAX
    package's ``parse_floats`` on the same text, exactly (f32, ``max_count``
    cutting both alike), and gives the rows back within rtol 1e-6; None
    without the library."""
    import yalla_tpu._native as j_native
    if _native.get_lib() is None or j_native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    arr = np.random.default_rng(3).random((100, 3)).astype(np.float32) \
        * 100 - 50
    text = _native.format_rows(arr)
    got = _native.parse_floats(text, 300)
    want = j_native.parse_floats(bytes(text).decode(), 300)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.allclose(got.reshape(100, 3), arr, rtol=1e-6)
    assert np.array_equal(_native.parse_floats(bytes(text).decode(), 7),
                          want[:7])
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", True)
    assert _native.parse_floats(text, 300) is None


def test_numpy_fallback_without_the_native_library(tmp_path, monkeypatch):
    """Without a compiler every consumer falls back to numpy formatting
    and parsing, and the round trip holds."""
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", True)
    assert _native.get_lib() is None
    pts, links, iprop, fprop = scene()["torch"]
    with Vtk_output("t", str(tmp_path), verbose=False) as out:
        per_array(out, pts, links, iprop, fprop, None)
        whole_frame(out, pts, links, iprop, fprop, None)
    for t in range(2):
        r = Solution(Po_cell4, N, solver="tile", device="cpu")
        inp = Vtk_input(str(tmp_path / f"t_{t}.vtk"))
        inp.read_positions(r)
        inp.read_field(r, "w")
        back = Property(N, "intprop", device="cpu")
        inp.read_property(back)
        assert np.allclose(r.h_X.y[:N], pts.h_X.y[:N], rtol=1e-5)
        assert np.allclose(r.h_X.w[:N], pts.h_X.w[:N], rtol=1e-5)
        assert np.array_equal(back.h_prop, iprop.h_prop)


def test_io_round_trip(tmp_path):
    """``tests/test_vtk.py::test_io`` on the port: write, then read
    positions, polarity, fields and properties back."""
    w, links, ints_w, floats_w = scene(seed=7)["torch"]
    out_dir = str(tmp_path) + "/"
    output = Vtk_output("test_vtk", out_dir, verbose=False)
    output.write_positions(w)
    output.write_polarity(w)
    output.write_field(w, "w")
    output.write_property(floats_w)
    output.write_property(ints_w)
    r = Solution(Po_cell4, N, solver="tile", device="cpu")
    inp = Vtk_input(out_dir + "test_vtk_0.vtk")
    assert inp.n_points == N
    inp.read_field(r, "w")
    inp.read_polarity(r)
    inp.read_positions(r)
    for f in ("x", "y", "z", "w", "phi", "theta"):
        assert isclose(getattr(w.h_X, f)[:N], getattr(r.h_X, f)[:N]), f
    ints_r = Property(N, "intprop", np.int32, device="cpu")
    floats_r = Property(N, "fprop", np.float32, device="cpu")
    inp.read_property(ints_r, "intprop")
    inp.read_property(floats_r)
    assert np.array_equal(ints_w.h_prop, ints_r.h_prop)
    assert isclose(floats_w.h_prop, floats_r.h_prop)
    with pytest.raises(KeyError, match="nothing"):
        inp.read_field(r, "nothing")


def test_async_write_propagates_worker_errors(tmp_path):
    pts = Solution(Float3, 8, solver="tile", device="cpu")
    pts.copy_to_device()
    out = Vtk_output("e", str(tmp_path) + "/", verbose=False,
                     async_write=True)
    out.write_positions(pts)
    out._current_path = str(tmp_path / "no-such-dir" / "zz.vtk")
    out.write_field(pts, "x")
    with pytest.raises(FileNotFoundError):
        out.close()
    assert out._pool is None and not out._pending


SUBMITS = {
    "write_frame": lambda out, pts, prop, mask: out.write_frame(
        pts, mask=mask, polarity=True, fields=("w",),
        properties=(prop, ("raw", prop.d_prop, np.int32))),
    "per_array": lambda out, pts, prop, mask: (
        out.write_positions(pts, mask=mask), out.write_polarity(pts),
        out.write_field(pts, "w"), out.write_property(prop)),
}


@pytest.mark.parametrize("how", list(SUBMITS))
def test_async_write_snapshots_on_submit(tmp_path, how):
    """Tensors are mutable: a queued write must hold the values of the
    moment it was submitted.  The worker is held back until the state, the
    property and the mask have been overwritten in place; the file must
    equal the one written synchronously beforehand."""
    pts, _, prop, _ = scene()["torch"]
    mask = torch.as_tensor(np.arange(N) % 3 != 0)
    with Vtk_output("t", str(tmp_path / "sync"), verbose=False) as out:
        SUBMITS[how](out, pts, prop, mask)
    gate = threading.Event()
    with Vtk_output("t", str(tmp_path / "async"), verbose=False,
                    async_write=True) as out:
        out._submit(lambda: gate.wait(30))      # blocks the one worker
        SUBMITS[how](out, pts, prop, mask)
        for a in pts.d_X:
            a.mul_(-3.0).add_(1.0)
        pts.d_n = 7
        prop.d_prop.zero_()
        mask.fill_(False)
        gate.set()
    assert (tmp_path / "async" / "t_0.vtk").read_bytes() == \
        (tmp_path / "sync" / "t_0.vtk").read_bytes()


def test_property_mirrors():
    p = Property(6, "kind", device="cpu")
    assert p.h_prop.dtype == np.int32 and p.d_prop is None
    assert p.copy_to_host() is p.h_prop
    p.h_prop[:] = np.arange(6)
    p.copy_to_device()
    p.h_prop[:] = -1                        # the device copy is its own
    assert p.d_prop.tolist() == list(range(6))
    h = p.copy_to_host()
    h[0] = 9                                # and so is the host mirror
    assert p.d_prop[0] == 0 and h.flags.writeable
    f = Property(3, "conc", np.float32, device="cpu")
    assert f.h_prop.dtype == np.float32 and f.name == "conc"


def _ckpt_objects(S, P, L, pt, fields, ints, **kw):
    n = len(ints)
    pts = S(pt, n, solver="tile", **kw)
    for f, a in fields.items():
        getattr(pts.h_X, f)[:n] = a
    pts.copy_to_device()
    links = L(5, strength=0.7, **kw)
    links.h_a[:5] = np.arange(5)
    links.h_b[:5] = np.arange(5) + 1
    links.copy_to_device()
    prop = P(pts.n_pad, "lineage", **kw)
    prop.h_prop[:n] = ints
    return pts, links, prop


def test_checkpoint_round_trip_and_jax_files(tmp_path):
    """``save_solution``/``load_solution`` round trip, into fresh objects
    and into the same ones, and across the packages: the port loads a
    checkpoint the JAX package wrote, and the other way round."""
    n = 70
    rng = np.random.default_rng(99)
    fields = {f: rng.random(n).astype(np.float32)
              for f in Po_cell4._fields}
    ints = rng.integers(0, 1000, n)
    pts, links, prop = _ckpt_objects(Solution, Property, Links, Po_cell4,
                                     fields, ints, device="cpu")
    pts.d_old_v = Float3(torch.full((pts.n_pad,), 0.25),
                         torch.zeros(pts.n_pad), torch.zeros(pts.n_pad))
    jpts, jlinks, jprop = _ckpt_objects(JSolution, JProperty, JLinks,
                                        JPo_cell4, fields, ints)
    jpts.d_old_v = jdt.Float3(jnp.full(jpts.n_pad, 0.25),
                              jnp.zeros(jpts.n_pad), jnp.zeros(jpts.n_pad))
    path, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    save_solution(path, pts, links=links, properties=(prop,),
                  extra={"step": np.int64(42)})
    j_save_solution(jpath, jpts, links=jlinks, properties=(jprop,),
                    extra={"step": np.int64(42)})
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    for source in (path, jpath):
        pts2 = Solution(Po_cell4, n, solver="tile", device="cpu")
        links2 = Links(5, device="cpu")
        prop2 = Property(pts2.n_pad, "lineage", device="cpu")
        extra = load_solution(source, pts2, links=links2,
                              properties=(prop2,))
        for f in Po_cell4._fields:
            np.testing.assert_array_equal(getattr(pts2.h_X, f)[:n],
                                          fields[f])
            np.testing.assert_array_equal(getattr(pts2.d_X, f).numpy()[:n],
                                          fields[f])
        assert pts2.h_n == pts2.d_n == n
        assert float(pts2.d_old_v.x[0]) == 0.25
        assert np.array_equal(links2.h_a[:5], links.h_a[:5])
        assert links2.d_b[:5].tolist() == [1, 2, 3, 4, 5]
        assert links2.strength == 0.7 and links2.d_n == 5
        assert np.array_equal(prop2.h_prop[:n], ints)
        assert int(extra["step"]) == 42
    j2 = JSolution(JPo_cell4, n, solver="tile")
    j_load_solution(path, j2)
    np.testing.assert_array_equal(j2.h_X.w[:n], fields["w"])

    # into the same objects, after they diverged
    prop.copy_to_device()
    prop.copy_to_host()
    prop.h_prop[:n] = -1
    pts.h_X.x[:n] = 0.0
    load_solution(path, pts, properties=(prop,))
    assert np.array_equal(prop.h_prop[:n], ints)
    np.testing.assert_array_equal(pts.h_X.x[:n], fields["x"])
    small = Solution(Po_cell4, 10, solver="tile", device="cpu")
    with pytest.raises(ValueError, match="larger than the capacity"):
        load_solution(path, small)
