"""Build the port's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``csrc/build/lib<name>-<hash>.so`` and loaded with ``ctypes``; the hash
covers the source, the shared headers and the flags, so an edited source
or header is rebuilt and a stale library is never loaded. A source's
compile-time sizes can be set by ``-D`` defines (``defines``), each set
building a library of its own. The host C++ of ``csrc/<name>.cpp`` (the
input pipeline) builds the same way with the host compiler
(:func:`build_host`: ``$CXX``, else ``g++``, with the JAX package's
Makefile flags). Nothing is built at import time: the CPU test suite
imports every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, per kernel
)

# tpu_dist/csrc/Makefile's CXXFLAGS and LDFLAGS, in its order around the source
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
CXX_LD_FLAGS = ("-shared", "-pthread")

_LOCK = threading.Lock()
_LIBS: Dict[tuple, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH); the "
            "port's CUDA kernels are built on the machine with the card"
        )
    return found


def _flags(defines: Sequence[str]) -> tuple:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to. The hash covers the source, every
    ``csrc/*.cuh`` header (so an edited shared header rebuilds the sources
    that may include it) and the flags, ``defines`` (``NAME=value``)
    included."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _compile(out: Path, source: Path, command) -> Tuple[Path, float, str]:
    """Run ``command(tmp)`` (a compiler command line that builds ``source``
    into ``tmp``) unless ``out`` exists, then move ``tmp`` to ``out``.
    Returns ``(out, seconds, compiler log)``; raises with the log when the
    compiler fails."""
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = command(str(tmp))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed on {source.name} "
                           f"(rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds, log


def build(name: str, defines: Sequence[str] = ()) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library already exists.
    Returns ``(path, seconds, compiler log)``; seconds and log are 0 and
    empty when nothing had to be built. Raises with the compiler's output
    when ``nvcc`` fails."""
    src = CSRC / f"{name}.cu"
    return _compile(library_path(name, defines), src,
                    lambda tmp: [nvcc(), *_flags(defines), "-o", tmp, str(src)])


def cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` (the Makefile's
    default)."""
    return os.environ.get("CXX") or "g++"


def host_library_path(name: str) -> Path:
    """Where ``csrc/<name>.cpp`` builds to; the hash covers the source, the
    compiler's name and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    digest.update(" ".join((cxx(), *CXX_FLAGS, *CXX_LD_FLAGS)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_host(name: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cpp`` with the host compiler unless its library
    already exists, as :func:`build` does a CUDA source. A missing
    compiler raises ``OSError``."""
    src = CSRC / f"{name}.cpp"
    return _compile(host_library_path(name), src,
                    lambda tmp: [cxx(), *CXX_FLAGS, str(src), "-o", tmp, *CXX_LD_FLAGS])


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with ``defines``),
    built first if needed."""
    key = (name, *defines)
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            path, _, _ = build(name, defines)
            lib = _LIBS[key] = ctypes.CDLL(str(path))
        return lib


def bind(name: str, symbol: str, argtypes, defines: Sequence[str] = ()):
    """The C function ``symbol`` of ``csrc/<name>.cu`` (built with
    ``defines``) with its argument types declared (``c_void_p`` for
    pointers and the stream, so none is cut to 32 bits) and its CUDA error
    code as the result."""
    fn = getattr(load(name, defines), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
