"""Build and load the hand-written CUDA kernels.

All of ``voxtral_tpu_torch/csrc/*.cu`` is compiled at first use, by
``nvcc`` alone, one process per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c -o <source>.o csrc/<source>.cu

then linked into one shared library with a plain C interface

    nvcc -shared -o _build/libvoxtral_kernels-<hash>.so *.o

and loaded with ``ctypes``.  The library name carries a hash of the
sources, so an edited source rebuilds and an unchanged one loads at once.
The build lands in ``voxtral_tpu_torch/_build/`` (git-ignored).  No
PyTorch header is compiled, which keeps a build to seconds.

Every C entry point returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.  A missing ``nvcc`` or a failed build
raises :class:`KernelBuildError` — there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# -fmad=false: no a*b+c contraction, so each float op rounds on its own
# as PyTorch's elementwise ops do (the kernels match their plain
# versions bit for bit).  Never --use_fast_math.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
]


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused the sources."""


def find_nvcc() -> Optional[str]:
    """``nvcc`` on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the kernels unless an up-to-date library exists.

    Returns (library path, seconds spent compiling; 0.0 when cached).
    """
    lib = BUILD_DIR / f"libvoxtral_kernels-{_source_hash()}.so"
    if lib.exists():
        return lib, 0.0
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of voxtral_tpu_torch are built from csrc/*.cu at first use and "
            "need the CUDA toolkit")
    srcs = sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c",
                         "-o", str(obj), str(src)]
                        for src, obj in zip(srcs, objs))]
        outs = [(cmd, proc, proc.communicate()[0]) for cmd, proc in procs]
        failed = [f"nvcc failed (exit {proc.returncode}):\n"
                  f"{' '.join(cmd)}\n{out}"
                  for cmd, proc, out in outs if proc.returncode != 0]
        if failed:
            raise KernelBuildError("\n".join(failed))
        # Link under a temporary name, then rename: a concurrent loader
        # never sees a half-written library.
        so = Path(tmp) / "lib.so"
        cmd = [nvcc, "-shared", "-o", str(so), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(so, lib)
    return lib, time.perf_counter() - t0


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process.  The first
    call builds it; threads that ask meanwhile (a server's handlers and
    its pump thread) wait for that one build instead of each running
    ``nvcc``."""
    with _LIBRARY_LOCK:
        return _load_library()


@functools.lru_cache(maxsize=1)
def _load_library() -> ctypes.CDLL:
    path, _ = build()
    return ctypes.CDLL(str(path))


def kernel_fn(name: str, argtypes: Sequence):
    """C entry point ``name`` with its ctypes signature set.

    Pointers and the stream are ``c_void_p`` (a bare Python int would be
    cut to 32 bits); every entry point returns a ``cudaError_t`` as int.
    The signature is set once per process (a wrapper asks for its entry
    point at every launch).
    """
    return _entry(name, tuple(argtypes))


@functools.lru_cache(maxsize=None)
def _entry(name: str, argtypes: tuple):
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
