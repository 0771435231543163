"""Build and load the package's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` compiles on its own, with a plain C interface, into
``build/repro_torch_kernels/<name>-<hash>.so`` under the repository root;
the hash covers the source, every ``csrc`` header it includes (``#include
"x.cuh"``, followed into headers) and the flags, so a stale library is
never loaded. ``build()`` starts one ``nvcc`` per missing library, all at once,
and waits for every one of them; ``load(name)`` builds at first use and
caches the handle for the process. A missing ``nvcc`` or a failed build
raises. ``stats()`` counts the libraries this process built and loaded,
with the seconds that took. Nothing here runs at import: the CPU tests
import every module of the package on machines without a compiler or a
card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
KERNELS = ("fused_gnn", "scatter_gather", "gat_attention",
           "flash_attention")
MAX_SMEM = 232_448      # shared memory one block may use on an H100 (bytes)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# this process's builds (nvcc runs: libraries, wall seconds of the build
# calls that ran them) and loads (libraries, seconds in ctypes)
_stats = {"built": 0, "built_s": 0.0, "loaded": 0, "loaded_s": 0.0}
_stats_lock = threading.Lock()


def stats() -> Dict[str, float]:
    """``{"built", "built_s", "loaded", "loaded_s"}``: the libraries this
    process compiled with ``nvcc`` and the wall seconds of the ``build``
    calls that compiled them (the compilers run together), and the
    libraries it loaded and the seconds the loads took."""
    with _stats_lock:
        return dict(_stats)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location. Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of repro_torch cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, directly or
    through other headers, in the order first reached."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(
            path.read_bytes()) if (CSRC / inc.decode()).exists()]
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(source: Path, out: Path) -> List[str]:
    """The compiler's command line for one library (headers from csrc)."""
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(source)]


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` each, all started together. Returns ``{name: ptxas report}``
    for the libraries built by this call (the register and shared-memory
    use ``-Xptxas -v`` prints). Raises on the first failed build, after
    every compiler has exited."""
    todo = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc_path()                         # raises before anything starts
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs: List = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((n, out, tmp, subprocess.Popen(
            nvcc_command(CSRC / f"{n}.cu", tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    reports, failed = {}, []
    for n, out, tmp, p in procs:
        stdout, stderr = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{stderr}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)            # atomic: readers never see a torn .so
        reports[n] = stdout + stderr
    with _stats_lock:
        _stats["built"] += len(reports)
        _stats["built_s"] += time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            t0 = time.perf_counter()
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            with _stats_lock:
                _stats["loaded"] += 1
                _stats["loaded_s"] += time.perf_counter() - t0
        return lib


def refuse_grad(kernel: str, *tensors) -> None:
    """Raises when grad mode is on and an input of ``kernel`` requires grad.
    The kernels write their outputs through ctypes into buffers autograd
    does not see, so such an output would carry no ``grad_fn`` and the
    gradient through the call would be dropped without a word. The plain
    versions (``impl="torch"`` programs, the ``*_ref`` functions) take
    autograd."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the CUDA kernel has no "
            f"backward (its output would carry no grad_fn and the gradient "
            f"would be lost); run the plain path (impl='torch', or "
            f"{kernel}_ref) or call it under torch.no_grad()")
