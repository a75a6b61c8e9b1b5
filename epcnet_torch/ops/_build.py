"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
       -shared -Xcompiler -fPIC -o csrc/build/lib<name>-<hash>.so csrc/<name>.cu

at first use, from the sources in the checkout only. The library name holds
a hash of the source and of the shared headers (``csrc/*.cuh``), so an
edited kernel is never served from a stale build, and it is written under a
temporary name and renamed, so processes may share the directory. The
directory is ``BUILD_DIR``, read at each build: ``csrc/build`` (listed in
``.gitignore``) unless ``utils/compile_cache.py`` points it elsewhere
(``--compilation_cache_dir``). ``-fmad=false``
keeps every product and sum separately rounded, which is what makes the kNN
distances bit-equal to the plain PyTorch version (the kernels also spell it
out with ``__fmul_rn``/``__fadd_rn``).

Nothing here runs at import: the CPU tests import every module of the port
and need no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# where builds go and are looked up; utils/compile_cache.py may repoint it
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# every kernel source of the port, csrc/<name>.cu
SOURCES = ("knn_adj", "knn_ids", "packed_mean", "knn_phase", "knn_pipelined",
           "indicator_mean", "knn_features", "bn_act", "edge_max", "sparse_conv")
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | tuple[str, ...]) -> dict[str, str]:
    """Compile the named sources that have no current build, one nvcc
    process each, all started together. Returns {name: ptxas report} for
    the sources compiled now (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        reports[name] = log
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(_target(name)[1]))
        return _libs[name]


def call(name: str, symbol: str, signature: str, *args) -> int:
    """Call the C entry ``symbol`` of ``csrc/<name>.cu`` with ``args`` typed
    by ``signature`` (one letter each: p pointer or None, i int, f float)
    and return its int result."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [_CTYPES[c] for c in signature]
    fn.restype = ctypes.c_int
    return fn(*args)


def launch(name: str, symbol: str, signature: str, *args) -> None:
    """``call`` a launch entry, which returns the launch's cudaError_t;
    anything but 0 raises."""
    err = call(name, symbol, signature, *args)
    if err != 0:
        raise RuntimeError(f"{symbol} (csrc/{name}.cu) failed: cudaError {err}")
