"""Where the port's compiled kernels persist (counterpart of
``epcnet_tpu/utils/compile_cache.py``).

The JAX package's compile step is XLA's, and its persistent cache makes a
rerun load compiled programs from disk. The port's compile step is the nvcc
build of ``csrc/*.cu`` (``ops/_build.py``), and its cache is the build
directory: each library is named by a hash of its source and of the shared
headers, and written to a temporary name, then renamed, so several
processes of one run may share the directory, as they may share JAX's. One
resolution policy for every CLI:

  explicit --compilation_cache_dir flag
    > EPCNET_COMPILATION_CACHE_DIR environment variable
      > the build directory as it stands (at first ``epcnet_torch/csrc/build``)

JAX's ``EPCNET_COMPILATION_CACHE_MIN_SECS`` (persist only programs slower
than a threshold to compile) has no meaning here: every kernel build is
kept.
"""

from __future__ import annotations

import os
from pathlib import Path

from epcnet_torch.ops import _build

ENV_VAR = "EPCNET_COMPILATION_CACHE_DIR"


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Point the kernel builds at ``cache_dir``, else at
    ``$EPCNET_COMPILATION_CACHE_DIR``; with neither the build directory is
    left as it is. Returns the directory builds now go to. Call before the
    first kernel launch: a library loaded earlier stays loaded."""
    resolved = cache_dir or os.environ.get(ENV_VAR) or None
    if resolved:
        _build.BUILD_DIR = Path(os.path.abspath(os.path.expanduser(resolved)))
    return str(_build.BUILD_DIR)


def add_cli_arg(ap) -> None:
    """Attach the shared --compilation_cache_dir flag to an argparse parser.

    Every CLI wires the cache identically:
        add_cli_arg(ap); ...; enable_compilation_cache(args.compilation_cache_dir)
    """
    ap.add_argument(
        "--compilation_cache_dir",
        default=None,
        help="directory of the compiled CUDA kernels (default: "
        f"${ENV_VAR}, else epcnet_torch/csrc/build); reruns load the "
        "compiled kernels from disk instead of rebuilding them with nvcc",
    )
