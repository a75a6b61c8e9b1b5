"""ctypes bindings for the native batch submap loader, ``native/loader.cpp``
(twin of ``epcnet_tpu/data/native_loader.py``; the same library).

``epcnet_load_batch`` reads many ``.bin`` files on a pool of threads,
float64 -> float32, without the GIL. ``ensure_built()`` builds
``native/libepcnet_loader.so`` with ``make -C native`` on first use; where
that fails the loader reads through this package's ``load_pc_file``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from epcnet_torch.data.pointclouds import load_pc_file

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libepcnet_loader.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def ensure_built(quiet: bool = True) -> bool:
    """Build the shared library if it is missing. True if it is there."""
    global _build_failed
    if os.path.isfile(_LIB_PATH):
        return True
    if _build_failed or not os.path.isfile(os.path.join(_NATIVE_DIR, "loader.cpp")):
        return False
    with _lock:
        if os.path.isfile(_LIB_PATH):
            return True
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=quiet)
        except (subprocess.CalledProcessError, FileNotFoundError):
            _build_failed = True
            return False
    return os.path.isfile(_LIB_PATH)


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not ensure_built():
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.epcnet_load_batch.restype = ctypes.c_int64
            lib.epcnet_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
            ]
            _lib = lib
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def load_pc_files_native(
    filenames,
    dataset_root: str = "",
    num_points: int = 4096,
    n_threads: int = 8,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Parallel batch load -> [len(filenames), num_points, 3] float32.

    Reads through ``load_pc_file`` when the library is unavailable. ``out``
    may be a preallocated destination."""
    lib = _get_lib()
    paths = [os.path.join(dataset_root, f) if dataset_root else f for f in filenames]
    n = len(paths)
    if out is None:
        out = np.empty((n, num_points, 3), np.float32)
    elif out.shape != (n, num_points, 3) or out.dtype != np.float32:
        raise ValueError(f"out is {out.dtype} {out.shape}, need float32 "
                         f"{(n, num_points, 3)}")

    if lib is None:
        for i, p in enumerate(paths):
            out[i] = load_pc_file(p, num_points=num_points)
        return out

    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.epcnet_load_batch(
        arr, n, num_points, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads
    )
    if rc != 0:
        raise IOError(f"native loader failed on {paths[rc - 1]!r}")
    return out
