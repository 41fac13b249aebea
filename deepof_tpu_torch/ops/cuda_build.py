"""Build the port's CUDA kernels with nvcc at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher and compiles on its own
into ``build/cuda/<name>-<digest>.so`` under the checkout (a directory that
``.gitignore`` lists). The digest covers the source and the flags, so an
edited source rebuilds and an unchanged one loads as built. ``build`` starts
one nvcc per missing library, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module of the port,
and this machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda")
SOURCES = ("window_gather", "gru_scan", "gru_scan_bwd", "hmm_scan", "kalman_rts")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one nvcc per source, all started
    together. Returns {name: compiler log} (ptxas register and shared
    memory use; empty for a library that was already built). Raises with
    nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, procs, logs = None, {}, {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            logs[name] = ""
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _loaded:
            build((name,))
            _loaded[name] = ctypes.CDLL(library_path(name))
        return _loaded[name]
