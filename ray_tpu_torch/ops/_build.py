"""Build and load the port's hand-written CUDA kernels (no counterpart
in ``ray_tpu``, whose Pallas kernels compile inside ``jax.jit``).

A source in ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, under
``build/ray_tpu_torch/`` at the root of the checkout, at first use
(``compile_all`` starts one nvcc per source, all at once). The
library's file name carries a digest of its source, of the headers
beside it and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded.
Python binds the C entries with ``ctypes`` (pointers and the stream as
``c_void_p``, ints as ``c_int``). ptxas's report of each build (``-Xptxas
-v``: registers, shared memory and spills per kernel) is kept beside the
library. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """Where ``source`` is built: named by a digest of its text, of the
    headers in ``csrc/`` it may include, and of the nvcc flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
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
    path.with_suffix(".ptxas.txt").write_text(err)
    os.replace(tmp, path)
    return path


def ptxas_report(source: str) -> str:
    """What ptxas said (registers, shared memory, spills per kernel)
    when ``source``'s library was built; "" if it is not built."""
    report = library_path(source).with_suffix(".ptxas.txt")
    return report.read_text() if report.is_file() else ""


# Itanium-mangled builtin types a kernel template takes
_MANGLED_TYPES = {"a": "int8_t"}
_INT_ARG = re.compile(r"Li(\d+)E")      # an int literal
_NAMED_ARG = re.compile(r"(\d+)")       # the length of a type's name


def _template_args(mangled: str, at: int):
    """The template arguments of a mangled name from ``at`` (just past
    its ``I``) to their closing ``E``: int literals (``Li64E``), builtin
    types (``a``: int8_t) and named types (``13__nv_bfloat16``); None
    for anything else."""
    args = []
    while at < len(mangled) and mangled[at] != "E":
        m = _INT_ARG.match(mangled, at)
        if m:
            args.append(m.group(1))
            at = m.end()
            continue
        m = _NAMED_ARG.match(mangled, at)
        if m:
            n = int(m.group(1))
            args.append(mangled[m.end():m.end() + n])
            at = m.end() + n
            continue
        if mangled[at] not in _MANGLED_TYPES:
            return None
        args.append(_MANGLED_TYPES[mangled[at]])
        at += 1
    return args if at < len(mangled) else None


def ptxas_summary(report: str, kernels: Sequence[str]) -> Dict[str, dict]:
    """{"name<args>": {"registers", "spill_stores", "spill_loads",
    "warnings"}} for each instance of the ``kernels`` in a ptxas report,
    named by its template arguments as C++ writes them ("name<64>",
    "name<64, 32>", "name<__nv_bfloat16, 64, 64>", "name<int8_t, 64,
    64>"); "warnings" holds ptxas's performance warnings for it (e.g.
    C7520, wgmma serialized) as it wrote them."""
    pattern = re.compile(r"\d(%s)I" % "|".join(map(re.escape, kernels)))
    out: Dict[str, dict] = {}
    name = None
    for line in report.splitlines():
        key = None
        for m in pattern.finditer(line):
            args = _template_args(line, m.end())
            if args:
                key = f"{m.group(1)}<{', '.join(args)}>"
                break
        if "Performance Loss" in line and key:
            reason = line.split("Performance Loss", 1)[1].lstrip(": ")
            out.setdefault(key, {"warnings": []})["warnings"].append(
                reason.split(" in the function")[0])
            continue
        if "Compiling entry function" in line:
            name = key
            if name:
                out.setdefault(name, {"warnings": []})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


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
