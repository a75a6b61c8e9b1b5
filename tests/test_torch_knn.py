"""K1's plain twin (``epcnet_torch.ops.knn.knn_adjacency`` on a CPU tensor)
against the JAX package: its jnp route and its Pallas kernel run in
interpret mode, as tests/test_knn.py runs it on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu.ops.knn import knn_adjacency as j_knn_adjacency
from epcnet_tpu.ops.knn import knn_with_adjacency_pallas

from epcnet_torch.ops import knn as tknn
from epcnet_torch.ops.knn import knn_adjacency

BF16_ULP = 2.0 ** -7


def _clouds(n, seed):
    """[2, N, 3] random clouds, and [2, N, 3] of the duplicates and
    degenerate cases of tests/test_knn.py:127-132 (21 identical points;
    every point identical)."""
    rng = np.random.RandomState(seed)
    random = rng.randn(2, n, 3).astype(np.float32)
    dup = rng.randn(n, 3).astype(np.float32)
    dup[40:60] = dup[5]
    hard = np.stack([dup, np.ones((n, 3), np.float32)])
    return {"random": random, "duplicates+degenerate": hard}


def _bf16_spacing(v):
    return BF16_ULP * 2.0 ** np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))


@pytest.mark.parametrize("n", [64, 150, 200])
@pytest.mark.parametrize("k", [5, 7, 20])
def test_knn_adjacency_twin_matches_jax(n, k):
    for name, x in _clouds(n, seed=n * 100 + k).items():
        for dt in ("bfloat16", "float32"):
            ind, proxy = knn_adjacency(torch.tensor(x), k, getattr(torch, dt))
            assert ind.dtype == torch.int8 and ind.shape == (2, n, n)
            assert proxy.dtype == getattr(torch, dt) and proxy.shape == (2, n, 3)
            ind = ind.numpy()
            proxy = proxy.float().numpy()
            _, j_ind, j_proxy = j_knn_adjacency(
                jnp.asarray(x), k, dtype=jnp.dtype(dt), impl="jnp",
                with_idx=False, with_proxy=True)
            _, p_ind, p_proxy = knn_with_adjacency_pallas(
                jnp.asarray(x), k, with_idx=False, with_proxy=True,
                proxy_dtype=dt)  # interpret mode off the TPU
            p_proxy = np.asarray(p_proxy.astype(jnp.dtype(dt)), np.float32)
            j_proxy = np.asarray(j_proxy, np.float32)
            msg = f"{name} n={n} k={k} {dt}"
            np.testing.assert_array_equal(ind, np.asarray(j_ind, np.int8), msg)
            np.testing.assert_array_equal(ind, np.asarray(p_ind), msg)
            np.testing.assert_array_equal(ind.sum(-1), k, msg)
            for want in (j_proxy, p_proxy):
                if dt == "bfloat16":  # 1 bf16 ulp: an fp32 sum in another order
                    assert np.all(np.abs(proxy - want) <= _bf16_spacing(want)), msg
                else:
                    np.testing.assert_allclose(proxy, want, rtol=1e-6, atol=1e-7,
                                               err_msg=msg)


def test_knn_adjacency_contract():
    x = torch.tensor(np.random.RandomState(3).randn(2, 5, 40, 3).astype(np.float32))
    ind, proxy = knn_adjacency(x, 6, torch.float32, with_proxy=False)
    assert proxy is None and ind.shape == (2, 5, 40, 40)
    ind2, _ = knn_adjacency(x.reshape(10, 40, 3), 6)
    np.testing.assert_array_equal(ind.reshape(10, 40, 40).numpy(), ind2.numpy())
    with pytest.raises(ValueError, match="k=50"):
        knn_adjacency(x, 50)
    with pytest.raises(ValueError, match="k=50"):
        tknn.knn_plain(x, 50)


def test_cpu_tensor_never_launches():
    """The plain twin is taken because the tensor lies on the CPU; the
    kernel's launch count stays put and nothing is built."""
    before = tknn.knn_adjacency_cuda.launches
    knn_adjacency(torch.zeros(1, 30, 3), 4)
    assert tknn.knn_adjacency_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        tknn.knn_adjacency_cuda(torch.zeros(1, 30, 3), 4)
