"""Build the CUDA C++ kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, on first use, into
``_build/`` beside this package (listed in ``.gitignore``).  The library's
file name carries a hash of its source, of every header ``csrc/*.cuh``
and of the flags, so an edited source or header is rebuilt and a stale
library is never loaded.  Only sources in the package
are built.  Nothing here runs at import time.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; the Python wrappers raise on nonzero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
build_seconds = 0.0   # wall seconds this process has spent in nvcc


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def sources() -> List[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    """``_build/<name>-<hash>.so``, the hash over ``csrc/<name>.cu``, every
    ``csrc/*.cuh`` (sorted by name; a source may include any of them) and
    the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC_DIR / f"{name}.cu")]


def build(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile every named source (all of ``csrc/`` if none are named)
    whose library is missing, one ``nvcc`` per source, all at once.
    Returns name -> library path.  ``-Xptxas -v`` output (registers,
    shared memory, spills) is kept in ``<library>.log``.  The wall seconds
    of the compiles are added to ``build_seconds``."""
    global build_seconds
    names = list(names) or sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {n: library_path(n) for n in names}
    t0 = time.perf_counter()
    procs = []
    for n, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(lib.with_suffix(".so.log"), "w")
        procs.append((n, lib, tmp, log, subprocess.Popen(
            nvcc_command(n, tmp), stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for n, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            errors = [line for line in Path(f"{lib}.log").read_text().splitlines()
                      if "error" in line]
            failed.append(f"{n} (nvcc exit {rc}, see {lib}.log):\n"
                          + "\n".join(errors[:20]))
    if procs:
        build_seconds += time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return libs


def load(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``csrc/<name>.cu``, built and loaded on
    first use, with its argument types declared (``c_void_p`` for pointers
    and the stream) and an ``int`` (CUDA error) result."""
    fn = _fns.get(symbol)
    if fn is None:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
