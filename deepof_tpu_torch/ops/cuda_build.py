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
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda")
SOURCES = ("window_gather", "gru_scan", "gru_scan_bwd", "hmm_scan", "kalman_rts", "gbm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# {library: {function: (argtypes, restype)}}: pointers and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints.
SIGNATURES = {
    "window_gather": {
        "window_streams_launch": ([_P] * 3 + [_I] * 4 + [_P] * 4, _I),
        "window_streams_config": ([_I] * 4 + [_P] * 2, _I),
    },
    "gru_scan": {
        "gru_scan_launch": ([_P] * 8 + [ctypes.c_float] + [_P] * 3 + [_I] * 6 + [_P], _I),
        "gru_scan_config": ([_I] * 6 + [_P], _I),
    },
    "gru_scan_bwd": {
        "gru_scan_bwd_launch": ([_P] * 13 + [_I] * 6 + [_P], _I),
        "gru_scan_bwd_config": ([_I] * 5 + [_P], _I),
    },
    "hmm_scan": {
        "hmm_scan_launch": ([_P] * 6 + [_I] * 3 + [_P], _I),
        "hmm_scan_config": ([_I] * 3 + [_P], _I),
    },
    "kalman_rts": {
        "kalman_rts_launch": ([_P] * 9 + [_I] * 3 + [_P], _I),
    },
    "gbm": {
        "gbm_histograms_launch": ([_P] * 6 + [_I] * 4 + [_P], _I),
        "gbm_best_split_launch": ([_P] * 8 + [_I] * 3 + [ctypes.c_double] * 2 + [_P], _I),
        "gbm_predict_launch": ([_P] * 9 + [_I] * 4 + [_P], _I),
    },
}

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


def _bind(name: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed,
    its functions bound to their ``SIGNATURES`` on the first load."""
    with _lock:
        if name not in _loaded:
            build((name,))
            _loaded[name] = _bind(name, library_path(name))
        return _loaded[name]


def use(name: str, path: Optional[str]) -> Optional[ctypes.CDLL]:
    """Serve ``load(name)`` from the library at ``path`` (a variant of
    ``csrc/<name>.cu`` built elsewhere, with the same C interface), bound
    to the same signatures; ``path=None`` returns to the checkout's own.
    Returns the library bound, or None."""
    with _lock:
        _loaded.pop(name, None)
        if path is not None:
            _loaded[name] = _bind(name, path)
        return _loaded.get(name)
