"""Build and load the hand-written Hopper kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, at first use, under ``build/kernels/`` beside
the package. All sources build at once, one ``nvcc`` each, in parallel.
A build is keyed by a hash of every source and header, so an edited
source rebuilds and an unchanged one is reused. Libraries load through
``ctypes``: pointers and the stream are ``c_void_p``, and each C entry
point returns a ``cudaError_t`` that :func:`check` turns into a
:class:`KernelLaunchError`: the one type of a launch that failed, which
the reader's retry loop retries. A build that fails (no ``nvcc``, a
compile error) raises a plain ``RuntimeError``, which it does not.

The host staging library (``native/staging.cpp``: the pool, the file
IO, the spill spooler and the serde codecs) builds the same way with
``g++`` (or ``$CXX``) into ``build/native/<hash>/``: :func:`build_native`.
A build that cannot run or fails raises ``RuntimeError`` naming why.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]



class PeerTable(ctypes.Structure):
    """``sr_ring_push``'s table of window base pointers, passed by value:
    one per process, at most 8 (the rest null); in one process, the
    receive buffer."""

    _fields_ = [("base", ctypes.c_void_p * 8)]


#: C signatures: name -> (argtypes, restype)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
SIGNATURES = {
    "bucket_scatter": {
        "sr_bucket_scatter": ([_P, _L, _L, _L, _I, _I, _I, _I, _I, _I, _P,
                               _I, _I, _I, _P, _L, _P, _P, _P, _L, _P], _I),
    },
    "merge_path": {
        "sr_merge_splits": ([_P, _P, _I, _L, _L, _L, _I, _P], _I),
        "sr_merge_stage": ([_P, _P, _P, _I, _L, _L, _L, _L, _I, _P], _I),
    },
    "partition_counts": {
        "sr_partition_counts": ([_P, _L, _L, _L, _I, _I, _I, _I, _I, _P, _I,
                                 _I, _P, _I, _P], _I),
    },
    "ring_exchange": {
        "sr_ring_push": ([_P, PeerTable, _I, _I, _I, _I, _L, _I, _I, _L,
                          _L, _I, _P], _I),
        "sr_window_alloc": ([_I, _L, _PP], _I),
        "sr_window_free": ([_I, _P], _I),
        "sr_ipc_export": ([_I, _P, _P], _I),
        "sr_ipc_open": ([_I, _P, _PP], _I),
        "sr_ipc_close": ([_I, _P], _I),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

NATIVE_SRC = Path(__file__).resolve().parent / "native" / "staging.cpp"
#: where :func:`build_native` publishes; read at each call
NATIVE_ROOT = Path(__file__).resolve().parent.parent / "build" / "native"
#: the JAX package's ``native/Makefile`` flags
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             "-pthread"]
#: sanitizer flavors: compile and link flags beside ``CXX_FLAGS``
FLAVOR_FLAGS = {
    "": [],
    "tsan": ["-g", "-fno-omit-frame-pointer", "-fsanitize=thread"],
    "asan": ["-g", "-fno-omit-frame-pointer",
             "-fsanitize=address,undefined"],
}
#: seconds each native build of this process took, by flavor
native_build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(CUDA toolkit missing)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source that is not built yet; returns name -> .so."""
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = {p.stem: (p, out_dir / f"lib{p.stem}.so")
               for p in sorted(CSRC.glob("*.cu"))}
    todo = {k: v for k, v in targets.items() if not v[1].is_file()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, (src, lib) in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        errors = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                os.unlink(tmp)
                errors.append(f"nvcc failed on {name}.cu:\n{log}")
            else:
                os.replace(tmp, lib)   # atomic: readers never see a stub
        if errors:
            raise RuntimeError("\n".join(errors))
    return {k: v[1] for k, v in targets.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building all at first
    use), with every entry point's argtypes and restype declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        # _lock holds the nvcc build on purpose: it runs once per
        # process, concurrent first callers wait for it instead of
        # compiling twice, and a built library is never rebuilt under
        # it. Leaf lock by design.
        # srlint: ignore[blocking-under-lock]
        paths = build_all()
        for lib_name, path in paths.items():
            if lib_name in _libs:
                continue
            cdll = ctypes.CDLL(str(path))
            for fn, (args, res) in SIGNATURES.get(lib_name, {}).items():
                f = getattr(cdll, fn)
                f.argtypes = args
                f.restype = res
            _libs[lib_name] = cdll
        return _libs[name]


def _cxx() -> str:
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if not found:
        raise RuntimeError(
            f"C++ compiler {name!r} not found: the native staging library "
            f"({NATIVE_SRC.name}) cannot be built — install g++ or point "
            "$CXX at one, or turn use_native_staging and serde_native off")
    return found


def native_lib_path(flavor: str = "") -> Path:
    """Where the library of ``flavor`` ('' plain, 'tsan', 'asan') lives:
    ``NATIVE_ROOT/<hash of source and flags>/``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(NATIVE_SRC.read_bytes())
    name = f"libsparkstaging-{flavor}.so" if flavor else \
        "libsparkstaging.so"
    return Path(NATIVE_ROOT) / h.hexdigest()[:16] / name


def build_native(flavor: str = "") -> Path:
    """Build the host staging library of ``flavor`` unless it is built
    already; returns its path. Concurrent callers each compile into a
    temporary file and publish with one ``os.replace``, so nobody loads
    a half-written library."""
    if flavor not in FLAVOR_FLAGS:
        raise ValueError(f"unknown native flavor {flavor!r} (expected one "
                         f"of {sorted(FLAVOR_FLAGS)})")
    lib = native_lib_path(flavor)
    if lib.is_file():
        return lib
    cxx = _cxx()
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    extra = FLAVOR_FLAGS[flavor]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, *extra, str(NATIVE_SRC),
                               "-o", tmp], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} could not build {NATIVE_SRC.name}: "
                           f"{e}") from e
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed on {NATIVE_SRC.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    native_build_seconds[flavor] = time.perf_counter() - t0
    return lib


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point returned a nonzero ``cudaError_t``."""

    def __init__(self, what: str, err: int):
        self.err = err
        super().__init__(f"{what} failed: cudaError_t {err}")


def check(err: int, what: str) -> None:
    """Raise :class:`KernelLaunchError` on a nonzero ``cudaError_t``
    returned by a C entry point."""
    if err:
        raise KernelLaunchError(what, err)


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches`` count: the service's
    tenant threads launch the same kernels at once, and a bare ``+= 1``
    from two threads can lose one."""
    with _count_lock:
        wrapper.launches += 1


def stream_ptr(index: int) -> int:
    """Raw pointer of PyTorch's current stream on card ``index`` (a graph
    capture's stream while one is capturing), read without making a
    ``Stream`` object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


__all__ = ["build_all", "library", "check", "stream_ptr", "count_launch",
           "BUILD_ROOT", "PeerTable",
           "KernelLaunchError", "build_native", "native_lib_path",
           "NATIVE_ROOT"]
