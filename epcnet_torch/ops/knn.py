"""k-nearest-neighbour graph of a point cloud (twin of ``epcnet_tpu/ops/knn.py``
on its dense, adjacency-only route).

``knn_adjacency`` builds, once per forward, the 0/1 indicator of each point's
k nearest points (self included) and the layer-0 proxy point (the mean of
those k points' coordinates). On a CUDA tensor it launches K1
(``csrc/knn_adj.cu``); on a CPU tensor it runs the plain version beside it.
There is no fallback from one to the other.

Order everywhere: ascending fp32 distance, then ascending index — the order
of ``jax.lax.top_k(-d)``.
"""

from __future__ import annotations

import ctypes

import torch

from epcnet_torch.ops import _build
from epcnet_torch.ops.adjacency import count_adjacency, neighbor_mean
from epcnet_torch.ops.pairwise import pairwise_sqdist


def knn_plain(x: torch.Tensor, k: int, return_dists: bool = False):
    """Plain kNN, the twin of ``knn_jnp``: the full pairwise matrix, then a
    stable sort (``torch.topk`` does not promise the lowest index first on
    ties) cut to the first k.

    Args:
      x: [..., N, D] coordinates. k: neighbours per point, self included.

    Returns:
      idx [..., N, k] int64 (and fp32 distances if asked), nearest first.
    """
    n = x.shape[-2]
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    d = pairwise_sqdist(x)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    if return_dists:
        return idx[..., :k], dist[..., :k]
    return idx[..., :k]


def knn_adjacency_plain(x: torch.Tensor, k: int, dtype=torch.bfloat16,
                        with_proxy: bool = True):
    """K1's plain version: ``knn_plain``, then ``count_adjacency``, then the
    proxy as ``neighbor_mean(x.to(dtype), indicator, dtype, 1/k)`` — the
    arithmetic of the JAX ``knn_adjacency(impl="jnp", with_proxy=True)``.
    Returns (indicator int8 [..., N, N], proxy [..., N, D] in ``dtype`` or
    None)."""
    ind = count_adjacency(knn_plain(x, k), x.shape[-2], torch.int8)
    if not with_proxy:
        return ind, None
    proxy = neighbor_mean(x.to(dtype), ind, compute_dtype=dtype,
                          adjacency_scale=1.0 / k)
    return ind, proxy


def knn_adjacency_cuda(x: torch.Tensor, k: int, dtype=torch.bfloat16,
                       with_proxy: bool = True):
    """Launch K1 on ``torch.cuda.current_stream()``. x: [B, N, 3] on the
    card. Outputs are allocated here; the kernel allocates nothing and does
    not synchronise. Each launch adds one to ``knn_adjacency_cuda.launches``.
    """
    if x.device.type != "cuda":
        raise ValueError(f"K1 takes a CUDA tensor, got {x.device}")
    if x.dim() != 3 or x.shape[-1] != 3:
        raise ValueError(f"K1 takes [B, N, 3] coordinates, got {tuple(x.shape)}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K1's proxy is bf16 or fp32, got {dtype}")
    b, n, _ = x.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, n={n}]")
    x = x.float().contiguous()
    adj = torch.empty((b, n, n), dtype=torch.int8, device=x.device)
    proxy = torch.empty((b, n, 3), dtype=dtype, device=x.device) if with_proxy else None
    lib = _build.load("knn_adj")
    fn = lib.knn_adj_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), b, n, k, adj.data_ptr(),
                 proxy.data_ptr() if with_proxy else None,
                 int(dtype == torch.bfloat16), 1.0 / k,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 (csrc/knn_adj.cu) launch failed: cudaError {err}")
    knn_adjacency_cuda.launches += 1
    return adj, proxy


knn_adjacency_cuda.launches = 0


def knn_adjacency(x: torch.Tensor, k: int, dtype=torch.bfloat16,
                  with_proxy: bool = True):
    """0/1 indicator adjacency and layer-0 proxy of each cloud — the
    counterpart of the JAX ``knn_adjacency(..., with_idx=False,
    with_proxy=True)`` on the dense route.

    Args:
      x: [..., N, 3] coordinates (fp32).
      k: neighbours per point, 1 <= k <= N (self included).
      dtype: compute dtype of the proxy (bf16 or fp32).

    Returns:
      (indicator int8 [..., N, N], proxy [..., N, 3] in ``dtype``, or None
      with ``with_proxy=False``). A CUDA tensor goes through K1, a CPU tensor
      through ``knn_adjacency_plain``.
    """
    *lead, n, d = x.shape
    if k > n:
        raise ValueError(
            f"k={k} > n={n}: a neighbour list cannot be longer than the cloud"
        )
    if x.device.type == "cpu":
        return knn_adjacency_plain(x, k, dtype, with_proxy)
    ind, proxy = knn_adjacency_cuda(x.reshape(-1, n, d), k, dtype, with_proxy)
    ind = ind.reshape(*lead, n, n)
    return ind, (proxy.reshape(*lead, n, d) if with_proxy else None)
