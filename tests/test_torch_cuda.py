"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA card and skip without one. This file imports no
JAX, so it runs where JAX is not installed:

  python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from epcnet_torch.configs import ModelConfig
from epcnet_torch.ops import knn
from epcnet_torch.train.step import build_embed_fn

pytestmark = pytest.mark.cuda
BF16_ULP = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _cloud(seed, b, n, dev, grid=None):
    x = np.random.default_rng(seed).uniform(-1, 1, (b, n, 3)).astype(np.float32)
    if grid:
        x = np.round(x * grid) / grid  # a coarse grid: distance ties everywhere
    return torch.tensor(x, device=dev)


@pytest.mark.parametrize("b,n,k,dtype,grid", [
    (2, 4096, 20, "bfloat16", None),
    (2, 4096, 20, "bfloat16", 6),
    (2, 1000, 7, "float32", 4),
    (3, 333, 20, "bfloat16", None),
    (1, 20000, 20, "bfloat16", None),  # xyz read from global memory
])
def test_k1_matches_plain(cuda, b, n, k, dtype, grid):
    x = _cloud(n + k, b, n, cuda, grid)
    dt = getattr(torch, dtype)
    before = knn.knn_adjacency_cuda.launches
    adj, proxy = knn.knn_adjacency(x, k, dt)
    assert knn.knn_adjacency_cuda.launches == before + 1
    adj_p, proxy_p = knn.knn_adjacency_plain(x, k, dt)
    assert adj.dtype == torch.int8 and proxy.dtype == dt
    assert torch.equal(adj, adj_p)
    want = proxy_p.float()
    err = (proxy.float() - want).abs()
    if dt == torch.bfloat16:
        spacing = BF16_ULP * torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))))
        assert bool((err <= spacing).all())
    else:
        assert bool((err <= 1e-6 * want.abs() + 1e-7).all())


def test_k1_rejects_bad_input(cuda):
    with pytest.raises(ValueError, match="k="):
        knn.knn_adjacency_cuda(_cloud(0, 1, 16, cuda), 17)
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        knn.knn_adjacency_cuda(torch.zeros(1, 16, 4, device=cuda), 4)


def test_model_kernel_path_matches_plain_twin(cuda):
    cfg = ModelConfig(num_points=512, proxyconv_channels=(16, 16, 16, 32),
                      lift_channels=(64, 128), feature_dim=128)
    embed = build_embed_fn(cfg, device=cuda)
    x = _cloud(5, 4, 512, cuda)
    with torch.inference_mode():
        d = embed(x)
        d_plain = embed.model.forward_graph(
            x, *knn.knn_adjacency_plain(x, cfg.knn_k, torch.bfloat16))
    assert d.shape == (4, 256) and bool(torch.isfinite(d).all())
    assert float((d - d_plain).abs().max()) <= 1e-3
