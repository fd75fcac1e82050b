"""Build and load the port's hand-written CUDA kernels (no counterpart
in ``ray_tpu``, whose Pallas kernels compile inside ``jax.jit``).

A source in ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, under
``build/ray_tpu_torch/`` at the root of the checkout, at first use
(``compile_all`` starts one nvcc per source, all at once). The
library's file name carries a digest of its source and of the flags,
so an edited source is rebuilt and a stale library is never loaded.
Python binds the C entries with ``ctypes`` (pointers and the stream as
``c_void_p``, ints as ``c_int``). Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda.
    Raises FileNotFoundError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise FileNotFoundError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels are built on the machine with the card")


def library_path(source: str) -> Path:
    """Where ``source`` is built: named by a digest of its text and of
    the nvcc flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def _start(source: str):
    """Start nvcc on ``source`` unless its library exists: ``None``, or
    (library path, temporary output, process)."""
    path = library_path(source)
    if path.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # written under a temporary name, so a cut build leaves no library
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return path, tmp, proc


def _finish(source: str, job) -> Path:
    """Wait for a started build; raises RuntimeError with the
    compiler's message when it failed."""
    path, tmp, proc = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} (exit "
                           f"{proc.returncode}):\n{out}{err}")
    os.replace(tmp, path)
    return path


def _compile(source: str) -> Path:
    job = _start(source)
    return library_path(source) if job is None else _finish(source, job)


def compile_all(sources: Iterable[str]) -> None:
    """Build every source of ``sources`` that has no library yet, one
    nvcc per source, all started together; raises RuntimeError naming
    every source that failed, after all builds have ended."""
    with _LOCK:
        jobs = [(s, _start(s)) for s in sources]
        errors = []
        for source, job in jobs:
            if job is not None:
                try:
                    _finish(source, job)
                except RuntimeError as e:
                    errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(source: str, bind: Callable[[ctypes.CDLL], None]
         ) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed;
    ``bind`` declares its C entries' argtypes/restype once, when the
    library is opened."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(source)))
            bind(lib)
            _LOADED[source] = lib
        return lib
