"""The kNN twins of the port on a CPU tensor against the JAX package: its jnp
route and its Pallas kernels run in interpret mode, as tests/test_knn.py runs
them on the CPU. ``knn`` (K2's plain version) against ``knn_jnp`` and
``knn_pallas``; ``knn_adjacency`` dense (K1's) and packed (K3's) against
``knn_adjacency(impl="jnp")`` and ``knn_with_adjacency_pallas``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu.ops.adjacency import pack_indicator as j_pack_indicator
from epcnet_tpu.ops.knn import knn_adjacency as j_knn_adjacency
from epcnet_tpu.ops.knn import knn_jnp, knn_pallas, knn_with_adjacency_pallas

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
@pytest.mark.parametrize("k", [5, 7, 20, 32, 33])  # K1 changes core past k = 32
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
    kernels' launch counts stay put and nothing is built."""
    counters = (tknn.knn_adjacency_cuda, tknn.knn_packed_cuda, tknn.knn_cuda)
    before = [c.launches for c in counters]
    knn_adjacency(torch.zeros(1, 32, 3), 4)
    knn_adjacency(torch.zeros(1, 32, 3), 4, fmt="packed")
    tknn.knn(torch.zeros(1, 32, 3), 4)
    assert [c.launches for c in counters] == before
    for launch in counters:
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch(torch.zeros(1, 32, 3), 4)


def _knn_cases():
    """[B, N, 3] clouds and k: random, the tie cases of tests/test_knn.py
    (:47 pairs of identical points, :94 every point identical), a coarse
    grid (ties everywhere), k = N, an N that is no tile multiple, a cloud
    stored along x (a scanner's order), and k one above the card's register
    list of 32, where K2 moves from its tiled core to the value rounds."""
    rng = np.random.RandomState(31)
    pairs = np.zeros((1, 16, 3), np.float32)
    pairs[0, :, 0] = np.repeat(np.arange(8), 2)
    grid = np.round(rng.uniform(-1, 1, (2, 200, 3)) * 3).astype(np.float32) / 3
    cases = {
        "random": (rng.randn(2, 256, 3).astype(np.float32), 20),
        "pairs_tied": (pairs, 4),
        "all_identical": (np.ones((1, 40, 3), np.float32), 5),
        "grid_ties": (grid, 9),
        "k_equals_n": (rng.randn(1, 32, 3).astype(np.float32), 32),
        "odd_n": (rng.randn(1, 130, 3).astype(np.float32), 6),
    }
    xs = rng.randn(1, 300, 3).astype(np.float32)
    cases["x_sorted"] = (xs[:, np.argsort(xs[0, :, 0], kind="stable")], 20)
    cases["k_above_32"] = (rng.randn(1, 64, 3).astype(np.float32), 33)
    return cases


@pytest.mark.parametrize("block_rows", [1, 7, 1024])
@pytest.mark.parametrize("case", sorted(_knn_cases()))
def test_knn_matches_jax(case, block_rows):
    """ids and distances equal ``knn_jnp``'s exactly, for any row block of
    the plain version, and the Pallas kernel's ids exactly."""
    x, k = _knn_cases()[case]
    idx, dist = tknn.knn_plain(torch.tensor(x), k, return_dists=True,
                               block_rows=block_rows)
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    jidx, jdist = knn_jnp(jnp.asarray(x), k, return_dists=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    if block_rows == 1024:  # the kernel and the dispatcher, once per case
        # the Pallas kernel in interpret mode rounds some distances one ulp
        # away from knn_jnp's, so its distances are held to the 1e-4 of
        # tests/test_knn.py:36; on the thirds grid that ulp reorders ties
        # (42 of 400 rows at d = 2/9), so its ids are held on the other cases
        if case != "grid_ties":
            pidx, pdist = knn_pallas(jnp.asarray(x), k, return_dists=True)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
            np.testing.assert_allclose(dist.numpy(), np.asarray(pdist), atol=1e-4)
        i2, d2 = tknn.knn(torch.tensor(x), k, return_dists=True)
        assert torch.equal(i2, idx) and torch.equal(d2, dist)
        assert torch.equal(tknn.knn(torch.tensor(x), k), idx)


@pytest.mark.parametrize("n,k", [(256, 7), (96, 20), (512, 16)])
def test_knn_adjacency_packed_matches_jax(n, k):
    """fmt="packed": K3's plain version against the JAX jnp route (planes
    equal, proxy as dense), and at N=256 against the Pallas kernel in
    interpret mode."""
    for name, x in _clouds(n, seed=n + k).items():
        for dt in ("bfloat16", "float32"):
            planes, proxy = knn_adjacency(torch.tensor(x), k, getattr(torch, dt),
                                          fmt="packed")
            assert planes.dtype == torch.int32 and planes.shape == (2, n, n // 32)
            dense, dproxy = knn_adjacency(torch.tensor(x), k, getattr(torch, dt))
            assert torch.equal(proxy, dproxy)
            _, j_planes, j_proxy = j_knn_adjacency(
                jnp.asarray(x), k, dtype=jnp.dtype(dt), impl="jnp",
                with_idx=False, with_proxy=True, fmt="packed")
            msg = f"{name} n={n} k={k} {dt}"
            np.testing.assert_array_equal(planes.numpy(), np.asarray(j_planes), msg)
            np.testing.assert_array_equal(
                planes.numpy(), np.asarray(j_pack_indicator(jnp.asarray(dense.numpy()))))
            want = np.asarray(j_proxy, np.float32)
            got = proxy.float().numpy()
            if dt == "bfloat16":
                assert np.all(np.abs(got - want) <= _bf16_spacing(want)), msg
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=msg)
            if n == 256:
                _, p_planes, _ = knn_with_adjacency_pallas(
                    jnp.asarray(x), k, with_idx=False, with_proxy=True,
                    fmt="packed", proxy_dtype=dt)  # interpret mode off the TPU
                np.testing.assert_array_equal(planes.numpy(), np.asarray(p_planes), msg)
    assert bool((planes < 0).any())  # plane 31, the sign bit, is hit


def test_knn_adjacency_packed_rejects_like_jax():
    """N % 32 != 0 refuses the packed format where the JAX pack_indicator
    does; an unknown format is refused too."""
    x = np.random.RandomState(4).randn(1, 100, 3).astype(np.float32)
    with pytest.raises(ValueError, match="divisible by 32"):
        j_knn_adjacency(jnp.asarray(x), 5, impl="jnp", with_idx=False, fmt="packed")
    with pytest.raises(ValueError, match="divisible by 32"):
        knn_adjacency(torch.tensor(x), 5, fmt="packed")
    with pytest.raises(ValueError, match="dense|packed"):
        knn_adjacency(torch.tensor(x), 5, fmt="csr")
