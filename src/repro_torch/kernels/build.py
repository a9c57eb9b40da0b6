"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exports plain C launch functions (no PyTorch
headers, so a build takes seconds, not minutes) and compiles into its own
shared library ``<build dir>/lib<name>.so`` for ``sm_90a``, loaded with
``ctypes``.  A library is rebuilt when it is missing or older than its
source; the build directory is ``build/kernels`` at the root of the
checkout (listed in ``.gitignore``), or ``$REPRO_TORCH_BUILD_DIR``.

Nothing here runs when a module is imported: the first launch of a kernel
builds its library, and ``build_all`` builds every source at once, one
``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("moe_gating", "moe_dispatch", "rwkv6_scan", "mamba2_ssd",
           "flash_attention", "rwkv6_scan_bwd", "mamba2_ssd_bwd",
           "decode_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas register/shared-memory report of each build, by source name
PTXAS_LOG: Dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else \
        Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib, src = _lib_path(name), CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _start(name: str) -> subprocess.Popen:
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent loader never sees
    # a half-written library
    tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    tmp = build_dir() / f"lib{name}.{os.getpid()}.tmp.so"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, _lib_path(name))
    PTXAS_LOG[name] = log


def build_all() -> List[str]:
    """Build every stale source in parallel; returns the names built."""
    with _LOCK:
        todo = [n for n in SOURCES if _stale(n)]
        procs = [(n, _start(n)) for n in todo]
        errors = []
        for n, p in procs:         # wait for every nvcc, then report
            try:
                _finish(n, p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return todo


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            if _stale(name):
                _finish(name, _start(name))
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launch function (a refused
    launch never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
