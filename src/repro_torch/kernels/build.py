"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  The build happens
at first use, under ``build/repro_torch/`` at the repository root, keyed by
a hash of the source with every ``csrc`` header it includes, the flags and
the compiler path, so an edited source or header rebuilds and an unchanged
one is loaded as it is.  ``build_all`` starts one
``nvcc`` per source at once.  A failed build raises; nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parents[1] / "build" / "repro_torch"
SOURCES = ("tlmm", "prefill_attention", "decode_attention", "paged_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, object] = {}
# name -> {"seconds": float, "log": str, "cached": bool} for the builds of
# this process (the -Xptxas -v register/spill report is in "log")
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(name: str, csrc: Path = CSRC) -> List[Path]:
    """``name``.cu and every header it includes with quotes from ``csrc``,
    transitively, in a fixed order: what its library is built from."""
    seen: List[Path] = []
    todo = [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo.extend(csrc / inc.decode() for inc in _LOCAL_INCLUDE.findall(path.read_bytes()))
    return seen


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of the source and its headers: an edited header rebuilds."""
    h = hashlib.sha256()
    for path in sources_of(name, csrc):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _lib_path(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update(source_digest(name).encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source that has no library yet, all at once (one
    ``nvcc`` process per source), then load them.  Returns ``BUILD_INFO``."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _LIBS:
            continue
        out = _lib_path(name, nvcc)
        if out.exists():
            BUILD_INFO[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log, "cached": False}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name, nvcc)))
    return BUILD_INFO


def function(lib: str, fn: str, argtypes):
    """The C entry point ``fn`` of library ``lib`` (built at first use),
    with its ``argtypes`` set and an int (cudaError_t) return."""
    key = (lib, fn)
    if key not in _FUNCS:
        if lib not in _LIBS:
            build_all([lib])
        f = getattr(_LIBS[lib], fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _FUNCS[key] = f
    return _FUNCS[key]


def check(rc: int, what: str, lib: Optional[str] = None) -> None:
    if rc != 0:
        msg = ""
        if lib in _LIBS:
            err = getattr(_LIBS[lib], "repro_cuda_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            msg = ": " + err(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}{msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_longlong
F = ctypes.c_float
