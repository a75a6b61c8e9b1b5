"""k-nearest-neighbour graph of a point cloud (twin of ``epcnet_tpu/ops/knn.py``).

- ``knn`` gives each point's k nearest ids (and distances): K2
  (``csrc/knn_ids.cu``) on a CUDA tensor, ``knn_plain`` on a CPU tensor.
  The model's gather route uses it.
- ``knn_adjacency`` builds, once per forward, the 0/1 indicator of each
  point's k nearest points (self included) and the layer-0 proxy point (the
  mean of those k points' coordinates), as an int8 [N, N] matrix
  (``fmt="dense"``: K1) or as int32 bit planes [N, N/32] (``fmt="packed"``:
  K3); both kernels are in ``csrc/knn_adj.cu``. A CPU tensor takes the plain
  version beside each kernel.
- ``knn_features`` gives each point's k nearest ids in feature space (bf16
  [B, N, D] on the card): K8 (``csrc/knn_features.cu``) on a CUDA tensor,
  ``knn_features_plain`` on a CPU tensor. DGCNN-VLAD's layers 1.. use it.

K1, K2, K3 and K8 run on the tiled selection core (``csrc/knn_tile.cuh``: a
block of query rows streams the cloud through shared memory, each thread
keeps a register top-k) for k up to its register list (32), and K1-K3 on the
warp-per-row value rounds of ``csrc/knn_core.cuh`` above it: a rule on k
that each kernel's C entry applies and reports, never a fallback (K8
refuses k > 32). There is no fallback from a kernel to its plain version
either. Order everywhere:
ascending fp32 distance (K8: score), then ascending index — the order of
``jax.lax.top_k(-d)``.
"""

from __future__ import annotations

import ctypes

import torch

from epcnet_torch.ops import _build
from epcnet_torch.ops.adjacency import count_adjacency, neighbor_mean, pack_indicator
from epcnet_torch.ops.pairwise import pairwise_sqdist


def _check_k(k: int, n: int) -> None:
    if not 1 <= k <= n:
        raise ValueError(
            f"k={k} must be in [1, n={n}]: a neighbour list cannot be longer "
            "than the cloud"
        )


def knn_plain(x: torch.Tensor, k: int, return_dists: bool = False,
              block_rows: int = 1024):
    """Plain kNN, the twin of ``knn_jnp``: for each block of ``block_rows``
    query rows, the [block, N] distances and a stable sort (``torch.topk``
    does not promise the lowest index first on ties) cut to the first k. No
    [N, N] matrix is held at once.

    Args:
      x: [..., N, D] coordinates. k: neighbours per point, self included.

    Returns:
      idx [..., N, k] int32 (and fp32 distances if asked), nearest first.
    """
    n = x.shape[-2]
    _check_k(k, n)
    ids, dists = [], []
    for r0 in range(0, n, block_rows):
        d = pairwise_sqdist(x[..., r0:r0 + block_rows, :], x)
        dist, idx = torch.sort(d, dim=-1, stable=True)
        ids.append(idx[..., :k].to(torch.int32))
        dists.append(dist[..., :k])
        del d, dist, idx
    idx = torch.cat(ids, dim=-2)
    return (idx, torch.cat(dists, dim=-2)) if return_dists else idx


def _cloud_batch(x: torch.Tensor, k: int, name: str) -> torch.Tensor:
    """Checks shared by the kNN kernels; returns x as fp32 contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes a CUDA tensor, got {x.device}")
    if x.dim() != 3 or x.shape[-1] != 3:
        raise ValueError(f"{name} takes [B, N, 3] coordinates, got {tuple(x.shape)}")
    _check_k(k, x.shape[1])
    return x.float().contiguous()


def _launch_ids(x, k, ids, dists, adj, split: int = 0) -> bool:
    """One launch of ``csrc/knn_ids.cu`` on checked tensors; the kernel picks
    its core by k (``split``: the tiled core's threads a row, 0 for the
    kernel's own choice). Returns True where the value rounds ran."""
    tiled = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        _build.launch("knn_ids", "knn_ids_launch", "piiipppipp", x.data_ptr(), x.shape[0],
                      x.shape[1], k, ids.data_ptr(),
                      None if dists is None else dists.data_ptr(),
                      None if adj is None else adj.data_ptr(), split,
                      ctypes.addressof(tiled), torch.cuda.current_stream().cuda_stream)
    return not tiled.value


def knn_cuda(x: torch.Tensor, k: int, return_dists: bool = False,
             with_adjacency: bool = False):
    """Launch K2 on ``torch.cuda.current_stream()``. x: [B, N, 3] on the
    card. Returns ids [B, N, k] int32, then the fp32 distances if
    ``return_dists``, then the int8 indicator [B, N, N] if
    ``with_adjacency`` (a tuple when more than the ids are asked for).

    k <= 32 runs the tiled core, a larger k the value rounds (the kernel's
    rule); both give the same ids and distances, checked on the card at
    k = 32 and 33. Each launch adds one to ``knn_cuda.launches``, and one
    the kernel reports as the value rounds also to
    ``knn_cuda.launches_rounds``."""
    x = _cloud_batch(x, k, "K2")
    b, n, _ = x.shape
    ids = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    dists = torch.empty((b, n, k), dtype=torch.float32, device=x.device) if return_dists else None
    adj = torch.empty((b, n, n), dtype=torch.int8, device=x.device) if with_adjacency else None
    knn_cuda.launches_rounds += _launch_ids(x, k, ids, dists, adj)
    knn_cuda.launches += 1
    out = (ids,) + ((dists,) if return_dists else ()) + ((adj,) if with_adjacency else ())
    return out if len(out) > 1 else ids


knn_cuda.launches = 0
knn_cuda.launches_rounds = 0


def knn(x: torch.Tensor, k: int, return_dists: bool = False):
    """Each point's k nearest ids, nearest first (the JAX ``knn``).

    Args:
      x: [..., N, D] coordinates (D = 3 on the card). k: 1 <= k <= N.

    Returns:
      idx [..., N, k] int32, and fp32 distances [..., N, k] with
      ``return_dists``. A CUDA tensor goes through K2, a CPU tensor through
      ``knn_plain``.
    """
    if x.device.type == "cpu":
        return knn_plain(x, k, return_dists)
    *lead, n, d = x.shape
    out = knn_cuda(x.reshape(-1, n, d), k, return_dists)
    if return_dists:
        return tuple(t.reshape(*lead, n, k) for t in out)
    return out.reshape(*lead, n, k)


def knn_adjacency_plain(x: torch.Tensor, k: int, dtype=torch.bfloat16,
                        with_proxy: bool = True, fmt: str = "dense"):
    """K1's and K3's plain version: ``knn_plain``, then ``count_adjacency``,
    then the proxy as ``neighbor_mean(x.to(dtype), indicator, dtype, 1/k)``
    and, for ``fmt="packed"``, ``pack_indicator`` — the arithmetic of the JAX
    ``knn_adjacency(impl="jnp", with_proxy=True, fmt=...)``. Returns
    (adjacency, proxy [..., N, D] in ``dtype`` or None)."""
    ind = count_adjacency(knn_plain(x, k), x.shape[-2], torch.int8)
    proxy = None
    if with_proxy:
        proxy = neighbor_mean(x.to(dtype), ind, compute_dtype=dtype,
                              adjacency_scale=1.0 / k)
    return (pack_indicator(ind) if fmt == "packed" else ind), proxy


def _launch_adj(x, k, dtype, with_proxy, pack, name, split: int = 0):
    """One launch of ``csrc/knn_adj.cu``: K1 (pack=False) or K3; the kernel
    picks its core (``split``: the tiled core's threads a row for either
    form, 0 for the kernel's own choice). Returns (adj, proxy, whether the
    value rounds ran)."""
    x = _cloud_batch(x, k, name)
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}'s proxy is bf16 or fp32, got {dtype}")
    b, n, _ = x.shape
    if pack and n % 32:
        raise ValueError(f"{name}: columns {n} not divisible by 32")
    shape, adt = ((b, n, n // 32), torch.int32) if pack else ((b, n, n), torch.int8)
    adj = torch.empty(shape, dtype=adt, device=x.device)
    proxy = torch.empty((b, n, 3), dtype=dtype, device=x.device) if with_proxy else None
    tiled = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        _build.launch("knn_adj", "knn_adj_launch", "piiippifiipp", x.data_ptr(), b, n, k,
                      adj.data_ptr(), proxy.data_ptr() if with_proxy else None,
                      int(dtype == torch.bfloat16), 1.0 / k, int(pack), split,
                      ctypes.addressof(tiled), torch.cuda.current_stream().cuda_stream)
    return adj, proxy, not tiled.value


def knn_adjacency_cuda(x: torch.Tensor, k: int, dtype=torch.bfloat16,
                       with_proxy: bool = True):
    """Launch K1 on ``torch.cuda.current_stream()``: the int8 indicator
    [B, N, N] and the proxy [B, N, 3] (K1′ without it). x: [B, N, 3] on the
    card. Outputs are allocated here; the kernel allocates nothing and does
    not synchronise. k <= 32 runs the tiled core, a larger k the value
    rounds (the kernel's rule); both are checked on the card at k = 32 and
    33. Each launch adds one to ``knn_adjacency_cuda.launches`` (with the
    proxy) or ``knn_adjacency_cuda.launches_no_proxy``, and one the kernel
    reports as the value rounds also to
    ``knn_adjacency_cuda.launches_rounds``."""
    adj, proxy, rounds = _launch_adj(x, k, dtype, with_proxy, False, "K1")
    knn_adjacency_cuda.launches_rounds += rounds
    if with_proxy:
        knn_adjacency_cuda.launches += 1
    else:
        knn_adjacency_cuda.launches_no_proxy += 1
    return adj, proxy


knn_adjacency_cuda.launches = 0
knn_adjacency_cuda.launches_no_proxy = 0
knn_adjacency_cuda.launches_rounds = 0


def knn_packed_cuda(x: torch.Tensor, k: int, dtype=torch.bfloat16,
                    with_proxy: bool = True):
    """Launch K3 on ``torch.cuda.current_stream()``: the indicator as int32
    bit planes [B, N, N/32] (N % 32 == 0) and the proxy [B, N, 3], equal to
    K1's. k <= 32 runs the tiled core, a larger k the value rounds with the
    packed write (the kernel's rule); both are checked on the card at
    k = 32 and 33. Each launch adds one to ``knn_packed_cuda.launches``,
    and one the kernel reports as the value rounds also to
    ``knn_packed_cuda.launches_rounds``."""
    planes, proxy, rounds = _launch_adj(x, k, dtype, with_proxy, True, "K3")
    knn_packed_cuda.launches_rounds += rounds
    knn_packed_cuda.launches += 1
    return planes, proxy


knn_packed_cuda.launches = 0
knn_packed_cuda.launches_rounds = 0


def knn_adjacency(x: torch.Tensor, k: int, dtype=torch.bfloat16,
                  with_proxy: bool = True, fmt: str = "dense"):
    """0/1 indicator adjacency and layer-0 proxy of each cloud — the
    counterpart of the JAX ``knn_adjacency(..., with_idx=False,
    with_proxy=True, fmt=fmt)``.

    Args:
      x: [..., N, 3] coordinates (fp32).
      k: neighbours per point, 1 <= k <= N (self included).
      dtype: compute dtype of the proxy (bf16 or fp32).
      fmt: "dense" (int8 [..., N, N]) or "packed" (int32 bit planes
        [..., N, N/32]; N % 32 == 0, else ``ValueError`` as the JAX
        ``pack_indicator`` raises).

    Returns:
      (adjacency, proxy [..., N, 3] in ``dtype``, or None with
      ``with_proxy=False``). A CUDA tensor goes through K1 (dense) or K3
      (packed), a CPU tensor through ``knn_adjacency_plain``.
    """
    if fmt not in ("dense", "packed"):
        raise ValueError(f"fmt must be dense|packed, got {fmt!r}")
    *lead, n, d = x.shape
    if x.device.type == "cpu":
        return knn_adjacency_plain(x, k, dtype, with_proxy, fmt)
    launch = knn_packed_cuda if fmt == "packed" else knn_adjacency_cuda
    adj, proxy = launch(x.reshape(-1, n, d), k, dtype, with_proxy)
    adj = adj.reshape(*lead, n, adj.shape[-1])
    return adj, (proxy.reshape(*lead, n, d) if with_proxy else None)


# K8's feature widths: multiples of 16 (the tensor cores' depth) up to 256;
# its k: up to the tiled core's register list (csrc/knn_tile.cuh kMaxK)
FEATURE_DEPTH = 16
MAX_FEATURE_DIM = 256
TILED_MAX_K = 32
# rows of the plain version's [rows, N] scores at a time
FEATURE_BLOCK_ROWS = 1024


def knn_features_plain(f: torch.Tensor, k: int) -> torch.Tensor:
    """K8's plain version: each point's k nearest ids by the score
    ``||f_j||^2 - 2 <f_i, f_j>`` (the squared distance without the row's
    own norm), nearest first, self included, ties to the lower index (a
    stable sort). The features are widened to fp32 (fp64 stays), so the
    products of bf16 values are exact and the sums fp32, as in the kernel;
    ``2 <.,.>`` is exact and the difference rounded once. A block of
    ``FEATURE_BLOCK_ROWS`` rows at a time.

    Args:
      f: [..., N, D] features. k: 1 <= k <= N.

    Returns:
      idx [..., N, k] int32.
    """
    n = f.shape[-2]
    _check_k(k, n)
    x = f.to(torch.promote_types(f.dtype, torch.float32))
    norms = (x * x).sum(-1)  # [..., N]
    ids = []
    for r0 in range(0, n, FEATURE_BLOCK_ROWS):
        s = norms[..., None, :] - 2 * torch.matmul(x[..., r0:r0 + FEATURE_BLOCK_ROWS, :],
                                                   x.transpose(-1, -2))
        ids.append(torch.sort(s, dim=-1, stable=True).indices[..., :k].to(torch.int32))
        del s
    return torch.cat(ids, dim=-2)


def knn_features_cuda(f: torch.Tensor, k: int) -> torch.Tensor:
    """Launch K8 on ``torch.cuda.current_stream()``. f: [B, N, D] bf16 on
    the card, D a multiple of 16 up to 256, 1 <= k <= min(N, 32). Returns
    ids [B, N, k] int32 (the fp32 norms are scratch allocated here). Each
    launch adds one to ``knn_features_cuda.launches``."""
    if f.device.type != "cuda":
        raise ValueError(f"K8 takes a CUDA tensor, got {f.device}")
    if f.dim() != 3 or f.dtype != torch.bfloat16:
        raise ValueError(f"K8 takes bf16 features [B, N, D], got {f.dtype} {tuple(f.shape)}")
    b, n, d = f.shape
    if d % FEATURE_DEPTH or not FEATURE_DEPTH <= d <= MAX_FEATURE_DIM:
        raise ValueError(f"K8 takes D a multiple of {FEATURE_DEPTH} up to "
                         f"{MAX_FEATURE_DIM}, got {d}")
    _check_k(k, n)
    if k > TILED_MAX_K:
        raise ValueError(f"K8 takes k <= {TILED_MAX_K} (its register list), got {k}")
    f = f.contiguous()
    if f.data_ptr() % 16:  # the kernel reads 16-byte chunks
        f = f.clone()
    ids = torch.empty((b, n, k), dtype=torch.int32, device=f.device)
    norms = torch.empty((b, n), dtype=torch.float32, device=f.device)
    with torch.cuda.device(f.device):
        _build.launch("knn_features", "knn_features_launch", "piiiippp", f.data_ptr(), b, n,
                      d, k, norms.data_ptr(), ids.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    knn_features_cuda.launches += 1
    return ids


knn_features_cuda.launches = 0


def knn_features(f: torch.Tensor, k: int) -> torch.Tensor:
    """Each point's k nearest ids in feature space, nearest first, self
    included, ties to the lower index.

    Args:
      f: [..., N, D] features (bf16 on the card, D a multiple of 16 up to
        256). k: 1 <= k <= N (k <= 32 on the card).

    Returns:
      idx [..., N, k] int32: K8 on a CUDA tensor (which raises on what it
      does not take), ``knn_features_plain`` on a CPU tensor.
    """
    if f.device.type == "cpu":
        return knn_features_plain(f, k)
    *lead, n, d = f.shape
    return knn_features_cuda(f.reshape(-1, n, d), k).reshape(*lead, n, k)
