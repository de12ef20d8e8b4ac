"""Build the hand-written CUDA kernels and bind them with ctypes.

Every ``csrc/*.cu`` file (with the shared ``csrc/*.cuh`` headers) is
compiled by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per file, all
started together, and linked into one shared library with a plain C
interface, at first use, into ``yalla_tpu_torch/_build/`` (git-ignored).  The library's file name
carries a hash of the sources and flags, so an edited kernel is rebuilt
and a built one is reused.  No PyTorch header is compiled, which keeps
the build to seconds.  nvcc's output, with ptxas's registers and spills
per kernel, is kept beside the library (``.log``).

Every C entry point launches on the stream it is given, allocates
nothing and returns ``cudaGetLastError()``; :func:`check` turns a nonzero
code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# No fast-math: binning and the cutoff must decide exactly as the plain
# torch versions do.
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
SIGNATURES = {
    # S, K, n_pad, n_slots, out, live, stream
    "yalla_pour": [_P, _I, _L, _L, _P, _P, _P],
    # chans[12], occ, echans[12], elive, eorder, estart, E_cap,
    # gx, gy, gz, C, cube_size, params[10], out, eout, stream
    "yalla_lattice_pair_branching": [_P, _P, _P, _P, _P, _P, _I,
                                     _I, _I, _I, _I, _F, _P, _P, _P, _P],
    # chans[kFields + 3], n, n_pad, params, out, stream
    "yalla_tile_pair_branching": [_P, _I, _I, _P, _P, _P],
    "yalla_tile_pair_sorting": [_P, _I, _I, _P, _P, _P],
    # Ri, Cj, n, n_pad, n_fields, n_channels, arities, friction, params,
    # out, stream
    "yalla_central_pair_sorting": [_P, _P, _I, _I, _I, _I, _P, _I, _P, _P,
                                   _P],
    # in, out, n, stream
    "yalla_rsqrtf": [_P, _P, _L, _P],
}


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return str(path)


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run(procs, cmds):
    """Wait for every process; raise with the output of any that failed.
    Returns their output."""
    logs = [p.communicate()[0] for p in procs]
    for p, cmd, log in zip(procs, cmds, logs):
        if p.returncode:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return logs


def _start(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build():
    """Compile the kernels if needed; returns the library's path."""
    out = BUILD_DIR / f"libyalla_kernels_{_source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    try:
        logs = _run([_start(c) for c in cmds], cmds)
        tmp = out.with_name(f"{tag}.tmp.so")
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        logs += _run([_start(link)], [link])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)
    return out


@functools.cache
def library():
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.yalla_error_string.argtypes = [ctypes.c_int]
    lib.yalla_error_string.restype = ctypes.c_char_p
    return lib


def check(code, what):
    """Raise if a C entry point returned a CUDA error code."""
    if code:
        msg = library().yalla_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def pointers(tensors):
    """A ctypes array of device pointers, kept alive by the caller."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def stream_handle(device):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
