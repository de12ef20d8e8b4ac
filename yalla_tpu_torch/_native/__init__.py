"""Native (C++) VTK serializer, bound via ctypes.

The port's own copy of ``yalla_tpu/_native``: ``vtkio_native.cpp`` is
built with ``g++`` at first use into ``yalla_tpu_torch/_build/``
(git-ignored; the library's name carries a hash of the source, so an
edited source is rebuilt).  Every consumer has a pure-Python fallback, so
a missing compiler never breaks the package: each function returns None
then.  The formatters return a view of their output buffer (bytes-like,
for a file opened in binary mode): no copy of a frame's tens of megabytes
is made while the interpreter lock is held, and the library call itself
releases the lock.  Beside the serializer, the library holds the mesh
exclusion test of ``mesh.py`` (:func:`test_exclusion`), built with OpenMP
where the compiler has it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils.profiling import count, span

_SRC = Path(__file__).resolve().parent / "vtkio_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    """Compile the source if its library is not there yet; returns the
    library's path."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libvtkio_native_{tag}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(exist_ok=True)
        count("setup.kernel_builds")
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC),
               "-o", str(tmp)]
        try:  # OpenMP spreads the mesh exclusion test over the points
            subprocess.run(cmd[:1] + ["-fopenmp"] + cmd[1:], check=True,
                           capture_output=True)
        except subprocess.CalledProcessError:
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def get_lib():
    """The loaded native library, or None (fallback to pure Python).  Its
    first call is the span ``setup.native`` (the build where needed, the
    load); ``setup.kernel_builds`` counts a build."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock, span("setup.native"):
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError):
            return None
        c_long, c_int = ctypes.c_long, ctypes.c_int
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.yt_format_rows.restype = c_long
        lib.yt_format_rows.argtypes = [fp, c_long, c_int, ctypes.c_char_p,
                                       c_long]
        lib.yt_format_ints.restype = c_long
        lib.yt_format_ints.argtypes = [ip, c_long, ctypes.c_char_p, c_long]
        lib.yt_format_vertices.restype = c_long
        lib.yt_format_vertices.argtypes = [c_long, ctypes.c_char_p, c_long]
        lib.yt_format_lines.restype = c_long
        lib.yt_format_lines.argtypes = [ip, ip, c_long, ctypes.c_char_p,
                                        c_long]
        lib.yt_parse_floats.restype = c_long
        lib.yt_parse_floats.argtypes = [ctypes.c_char_p, c_long, fp, c_long]
        lib.yt_parse_doubles.restype = c_long
        lib.yt_parse_doubles.argtypes = [
            ctypes.c_char_p, c_long, ctypes.POINTER(ctypes.c_double), c_long]
        dp = ctypes.POINTER(ctypes.c_double)
        lib.yt_test_exclusion.restype = c_long
        lib.yt_test_exclusion.argtypes = [
            dp, c_long, dp, c_long, dp, ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _text(buf, written):
    """The ``written`` bytes of ASCII in ``buf`` as a view (no copy)."""
    return memoryview(buf)[:written] if written >= 0 else None


def format_rows(arr):
    """[n, k] or [n] float array -> ASCII rows, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, np.float32)
    if a.ndim == 1:
        a = a[:, None]
    n, width = a.shape
    cap = n * width * 18 + 64
    buf = ctypes.create_string_buffer(cap)
    return _text(buf, lib.yt_format_rows(_fptr(a), n, width, buf, cap))


def format_ints(arr):
    """int array -> one int per line, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, np.int32)
    cap = len(a) * 14 + 64
    buf = ctypes.create_string_buffer(cap)
    return _text(buf, lib.yt_format_ints(_iptr(a), len(a), buf, cap))


def format_vertices(n):
    """The VERTICES block of ``n`` points, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    cap = n * 16 + 64
    buf = ctypes.create_string_buffer(cap)
    return _text(buf, lib.yt_format_vertices(n, buf, cap))


def format_lines(a, b):
    """The LINES block of the links (a, b), or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    aa = np.ascontiguousarray(a, np.int32)
    bb = np.ascontiguousarray(b, np.int32)
    cap = len(aa) * 28 + 64
    buf = ctypes.create_string_buffer(cap)
    return _text(buf, lib.yt_format_lines(_iptr(aa), _iptr(bb), len(aa), buf,
                                          cap))


def parse_floats(text, max_count):
    """Up to ``max_count`` whitespace-separated numbers of ``text`` (a str
    or bytes-like, as the formatters return) as f32, or None if
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    raw = text.encode() if isinstance(text, str) else bytes(text)
    out = np.empty(max_count, np.float32)
    k = lib.yt_parse_floats(raw, len(raw), _fptr(out), max_count)
    return out[:k]


def parse_doubles(text, max_count):
    """Up to ``max_count`` whitespace-separated numbers of ``text`` as
    f64, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    raw = text.encode() if isinstance(text, str) else text
    out = np.empty(max_count, np.float64)
    k = lib.yt_parse_doubles(
        raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_count)
    return out[:k]


def test_exclusion(points, facet_vertices, ray_dir):
    """Ray-parity point-in-closed-mesh test (True = outside) on the native
    library, or None if unavailable.  ``points`` [n, 3], ``facet_vertices``
    [f, 3, 3], ``ray_dir`` [3] (the reference's fixed direction,
    mesh.cuh:390), all f64."""
    lib = get_lib()
    if lib is None:
        return None
    P = np.ascontiguousarray(points, np.float64)
    V = np.ascontiguousarray(facet_vertices, np.float64)
    d = np.ascontiguousarray(ray_dir, np.float64)
    out = np.empty(len(P), np.uint8)

    def dptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    n = lib.yt_test_exclusion(
        dptr(P), len(P), dptr(V), len(V), dptr(d),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool) if n == len(P) else None
