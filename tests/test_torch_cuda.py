"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA card and skip without one. This file imports no
JAX, so it runs where JAX is not installed:

  python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: ids, distances, indicators, bit planes and K5's values exactly
equal (K5's and K6's also at every forced threads-a-row S of the tiled
core); the proxy within 1 bf16 ulp (an fp32 sum in another order), or 1e-6
relative in fp32 (K6's too). K4 sums the set rows of F in fp32 where its
twin runs cuBLAS, so the two differ by fp32 rounding of the sum, at most about 1e-6 of the mean of
|F| over the row's set bits: bf16 results within 1 bf16 ulp plus that, fp32
results within that.
"""

import os

import numpy as np
import pytest
import torch

from epcnet_torch.configs import ModelConfig, pointnetvlad_config
from epcnet_torch.evals import get_recall, retrieval_latency_probe
from epcnet_torch.ops import adjacency, knn, knn_phases
from epcnet_torch.serve import PlaceIndex
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.weights import init_flat_variables

pytestmark = pytest.mark.cuda
BF16_ULP = 2.0 ** -7
BF16_TOL = 2e-4  # tests/test_torch_models.py: the port against JAX in bf16
TILED_MAX_K = 32  # the tiled core of K1-K3: its register list (knn_tile.cuh)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _cloud(seed, b, n, dev, grid=None):
    x = np.random.default_rng(seed).uniform(-1, 1, (b, n, 3)).astype(np.float32)
    if grid == "same":
        x[:] = 0.25  # all points identical: every distance ties
    elif grid == "xsorted":  # a scanner's order: the tiled core's most insertions
        x = np.take_along_axis(x, np.argsort(x[..., :1], axis=1, kind="stable"), axis=1)
    elif grid:
        x = np.round(x * grid) / grid  # a coarse grid: distance ties everywhere
    return torch.tensor(x, device=dev)


def _bf16_spacing(want):
    return BF16_ULP * torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))))


def _assert_proxy_close(got, want, dt):
    err = (got.float() - want.float()).abs()
    if dt == torch.bfloat16:
        assert bool((err <= _bf16_spacing(want.float())).all())
    else:
        assert bool((err <= 1e-6 * want.float().abs() + 1e-7).all())


@pytest.mark.parametrize("b,n,k,dtype,grid", [
    (2, 4096, 20, "bfloat16", None),
    (2, 4096, 20, "bfloat16", 6),
    (2, 1000, 7, "float32", 4),
    (3, 333, 20, "bfloat16", None),
    (1, 20000, 20, "bfloat16", None),  # 20 tiles, the last one partial
    (2, 4096, 32, "bfloat16", None),  # k at the register list's size
    (2, 4096, 33, "bfloat16", None),  # one above: the value rounds
    (2, 4096, 20, "bfloat16", "xsorted"),  # scan order
    (1, 8192, 20, "float32", 6),  # ties across tiles
    (2, 4096, 20, "bfloat16", "same"),  # all points identical
    (2, 1025, 20, "bfloat16", None),  # one point past a tile, N % 16 != 0
    (1, 4097, 20, "float32", None),  # one past the serving N
])
def test_k1_matches_plain(cuda, b, n, k, dtype, grid):
    x = _cloud(n + k, b, n, cuda, grid)
    dt = getattr(torch, dtype)
    before = knn.knn_adjacency_cuda.launches, knn.knn_adjacency_cuda.launches_rounds
    adj, proxy = knn.knn_adjacency(x, k, dt)
    assert knn.knn_adjacency_cuda.launches == before[0] + 1
    assert knn.knn_adjacency_cuda.launches_rounds == before[1] + (k > TILED_MAX_K)
    adj_p, proxy_p = knn.knn_adjacency_plain(x, k, dt)
    assert adj.dtype == torch.int8 and proxy.dtype == dt
    assert torch.equal(adj, adj_p)
    _assert_proxy_close(proxy, proxy_p, dt)


def test_k1_rejects_bad_input(cuda):
    with pytest.raises(ValueError, match="k="):
        knn.knn_adjacency_cuda(_cloud(0, 1, 16, cuda), 17)
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        knn.knn_adjacency_cuda(torch.zeros(1, 16, 4, device=cuda), 4)


@pytest.mark.parametrize("b,n,k,grid", [
    (2, 4096, 20, None),
    (2, 4096, 20, 6),  # ties
    (2, 1001, 7, 4),  # odd N, ties
    (1, 33, 33, None),  # k = N
    (1, 1, 1, None),
    (1, 20000, 20, None),  # xyz read from global memory
    (1, 40000, 20, None),  # a gather-route size
    (1, 1024, 20, None),  # one tile of the tiled core exactly
    (1, 1025, 20, None),  # one point past it
    (1, 65536, 20, 6),  # ties across tiles and split columns
    (1, 40000, 20, "same"),  # all points identical
    (1, 32768, 20, "xsorted"),  # scan order
    (2, 4096, 32, None),  # k at the register list's size
    (2, 4096, 33, None),  # one above: the value rounds
])
def test_k2_matches_plain(cuda, b, n, k, grid):
    x = _cloud(n + 2 * k, b, n, cuda, grid)
    before = knn.knn_cuda.launches, knn.knn_cuda.launches_rounds
    ids, dists = knn.knn(x, k, return_dists=True)
    assert knn.knn_cuda.launches == before[0] + 1
    assert knn.knn_cuda.launches_rounds == before[1] + (k > TILED_MAX_K)
    ids_p, dists_p = knn.knn_plain(x, k, return_dists=True)
    assert ids.dtype == torch.int32 and dists.dtype == torch.float32
    assert torch.equal(ids, ids_p) and torch.equal(dists, dists_p)
    assert torch.equal(knn.knn_cuda(x, k), ids)  # ids alone, no distances


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("n,k,grid", [(1025, 20, None), (4096, 32, 6), (8192, 20, "xsorted")])
def test_tiled_core_splits_match_plain(cuda, split, n, k, grid):
    """The tiled core with a row's columns over S threads, S forced: K2's
    ids and distances, K1's indicator and proxy, and K3's planes and proxy
    as with the wrapper's S."""
    x = _cloud(n + split, 2, n, cuda, grid)
    ids_p, dists_p = knn.knn_plain(x, k, return_dists=True)
    ids, dists = torch.empty_like(ids_p), torch.empty_like(dists_p)
    assert not knn._launch_ids(x, k, ids, dists, None, split)  # the tiled core ran
    assert torch.equal(ids, ids_p) and torch.equal(dists, dists_p)
    adj, proxy, rounds = knn._launch_adj(x, k, torch.bfloat16, True, False, "K1", split)
    assert not rounds
    adj_w, proxy_w = knn.knn_adjacency_cuda(x, k)
    assert torch.equal(adj, adj_w) and torch.equal(proxy, proxy_w)
    assert torch.equal(adj, knn.knn_adjacency_plain(x, k, with_proxy=False)[0])
    xp = x[:, : n // 32 * 32].contiguous()
    planes, proxy, rounds = knn._launch_adj(xp, k, torch.bfloat16, True, True, "K3", split)
    assert not rounds
    planes_w, proxy_w = knn.knn_packed_cuda(xp, k)
    assert torch.equal(planes, planes_w) and torch.equal(proxy, proxy_w)
    assert torch.equal(planes, knn.knn_adjacency_plain(xp, k, fmt="packed")[0])


def test_forced_split_refused_above_the_register_list(cuda):
    """k = 33 runs the value rounds, which take no S: a forced S raises."""
    x = _cloud(7, 1, 256, cuda)
    ids = torch.empty((1, 256, 33), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="knn_ids_launch"):
        knn._launch_ids(x, 33, ids, None, None, 2)
    with pytest.raises(RuntimeError, match="knn_adj_launch"):
        knn._launch_adj(x, 33, torch.bfloat16, True, True, "K3", 2)
    assert knn._launch_ids(x, 33, ids, None, None, 0)  # the rounds, by the rule


def test_k2_indicator_matches_k1(cuda):
    x = _cloud(3, 2, 4096, cuda, grid=8)
    ids, adj = knn.knn_cuda(x, 20, with_adjacency=True)
    assert torch.equal(ids, knn.knn_plain(x, 20))
    assert torch.equal(adj, knn.knn_adjacency_plain(x, 20, with_proxy=False)[0])
    ids2, dists, adj2 = knn.knn_cuda(x, 20, return_dists=True, with_adjacency=True)
    assert torch.equal(ids2, ids) and torch.equal(adj2, adj) and dists.shape == ids.shape


@pytest.mark.parametrize("b,n,k,dtype,grid", [
    (2, 4096, 20, "bfloat16", None),
    (2, 4096, 20, "bfloat16", 6),  # ties
    (2, 1024, 7, "float32", 4),
    (1, 32, 32, "bfloat16", None),  # k = N, one word per row
    (1, 20480, 20, "bfloat16", None),  # xyz read from global memory
    (1, 1024, 20, "bfloat16", None),  # one tile of the tiled core exactly
    (1, 1056, 20, "bfloat16", None),  # one word column past it
    (1, 40000, 20, "bfloat16", "same"),  # all points identical
    (1, 32768, 20, "float32", "xsorted"),  # scan order
    (1, 4096, 32, "bfloat16", None),  # k at the register list's size
    (1, 4096, 33, "bfloat16", None),  # one above: the value rounds
])
def test_k3_matches_plain(cuda, b, n, k, dtype, grid):
    x = _cloud(n + 3 * k, b, n, cuda, grid)
    dt = getattr(torch, dtype)
    before = knn.knn_packed_cuda.launches, knn.knn_packed_cuda.launches_rounds
    planes, proxy = knn.knn_adjacency(x, k, dt, fmt="packed")
    assert knn.knn_packed_cuda.launches == before[0] + 1
    assert knn.knn_packed_cuda.launches_rounds == before[1] + (k > TILED_MAX_K)
    planes_p, proxy_p = knn.knn_adjacency_plain(x, k, dt, fmt="packed")
    assert planes.dtype == torch.int32 and planes.shape == (b, n, n // 32)
    assert torch.equal(planes, planes_p)
    # plane 31, the sign bit, is hit (identical points: the winners are 0..k-1)
    assert bool((planes < 0).any()) or grid == "same"
    _assert_proxy_close(proxy, proxy_p, dt)
    # the same kernel core as K1: its proxy is K1's, bit for bit
    assert torch.equal(proxy, knn.knn_adjacency_cuda(x, k, dt)[1])
    with pytest.raises(ValueError, match="divisible by 32"):
        knn.knn_adjacency(x[:, :n - 1], min(k, n - 1), dt, fmt="packed")


def _k4_check(f, planes, k, dt):
    got = adjacency.packed_neighbor_mean(f, planes, k, dt)
    want = adjacency.packed_neighbor_mean_plain(f, planes, k, dt).float()
    scale = adjacency.packed_neighbor_mean_plain(f.abs().float(), planes, k,
                                                 torch.float32)
    assert got.dtype == f.dtype and got.shape == want.shape
    err = (got.float() - want).abs()
    tol = 1e-6 * scale + (_bf16_spacing(want) if f.dtype == torch.bfloat16 else 0)
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("b,n,c,density,fdtype,dtype", [
    (2, 4096, 64, None, "bfloat16", "bfloat16"),  # K3's planes, k per row
    (2, 4096, 64, 0.05, "bfloat16", "bfloat16"),  # popcount != k
    (1, 2048, 48, 0.3, "float32", "float32"),
    (1, 1024, 300, 0.05, "bfloat16", "bfloat16"),  # channels in two blocks
    (2, 256, 16, 0.5, "bfloat16", "float32"),  # bf16 features, fp32 compute
    (1, 96, 3, 0.1, "float32", "bfloat16"),  # W=3 words, fewer than a warp
    (2, 4096, 64, "edited", "bfloat16", "bfloat16"),  # K3's planes, edited
    (2, 4096, 48, "edited", "float32", "float32"),
    (2, 512, 64, 1.0, "bfloat16", "bfloat16"),  # every bit set
    (1, 1024, 3, 1.0, "float32", "float32"),
])
def test_k4_matches_plain(cuda, b, n, c, density, fdtype, dtype):
    """"edited": K3's planes with rows that hold no bit, a word with all 32
    planes set, and rows with more than 32 non-zero words."""
    rng = np.random.default_rng(n + c)
    k = 20
    if density in (None, "edited"):
        planes, _ = knn.knn_adjacency(_cloud(n, b, n, cuda), k, fmt="packed")
        if density == "edited":
            planes[:, :50] = 0
            planes[:, 50:100, 3] = -1
            planes[:, 100:150, :40] |= 1 << 30
    else:
        mask = torch.tensor(rng.uniform(size=(b, n, n)) < density, device=cuda)
        mask[:, :, -1] = True  # a column of plane 31
        planes = adjacency.pack_indicator(mask.to(torch.int8))
    f = torch.tensor(rng.standard_normal((b, n, c)).astype(np.float32),
                     device=cuda).to(getattr(torch, fdtype))
    before = adjacency.packed_neighbor_mean_cuda.launches
    _k4_check(f, planes, k, getattr(torch, dtype))
    assert adjacency.packed_neighbor_mean_cuda.launches == before + 1


def test_gather_mean_takes_int32_ids(cuda):
    x = _cloud(9, 2, 3000, cuda)
    ids = knn.knn(x, 20)
    f = torch.randn(2, 3000, 64, device=cuda).to(torch.bfloat16)
    got = adjacency.gather_neighbor_mean(f, ids)
    want = adjacency.gather_neighbor_mean(f, ids.long())
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


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


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 1e-3), ("float32", 2e-5)])
@pytest.mark.parametrize("route", ["packed", "gather"])
def test_routes_match_dense(cuda, route, dtype, tol):
    """N=2048: each capacity route against the dense route, same weights.
    bf16: 1e-3, what a 1-ulp bf16 difference in a neighbour mean moves a
    descriptor entry by at most; fp32: the JAX package's gather tolerance."""
    cfg = ModelConfig(num_points=2048, proxyconv_channels=(16, 16, 16, 32),
                      lift_channels=(64, 128), feature_dim=128, compute_dtype=dtype)
    x = _cloud(11, 2, 2048, cuda)
    dense = build_embed_fn(cfg.variant(adjacency_format="dense"), device=cuda)
    other = build_embed_fn(cfg.variant(adjacency_format=route), device=cuda)
    counter = knn.knn_packed_cuda if route == "packed" else knn.knn_cuda
    before = counter.launches, adjacency.packed_neighbor_mean_cuda.launches
    d_other = other(x)
    assert counter.launches == before[0] + 1
    assert adjacency.packed_neighbor_mean_cuda.launches == before[1] + (
        3 if route == "packed" else 0)
    d_dense = dense(x)
    assert d_other.shape == (2, 256) and bool(torch.isfinite(d_other).all())
    assert float((d_other - d_dense).abs().max()) <= tol


def _phase_cloud(case, dev):
    """K5's inputs: {-1, 0, 1} coordinates have about 10 distinct distances a
    row (+inf at 20 rounds); a dyadic grid ties in every row and across
    tiles."""
    b, n, grid = {"n1024": (2, 1024, None), "n1025": (2, 1025, None),
                  "n4097": (1, 4097, None), "dyadic": (2, 4096, 8), "few": (1, 1000, 1),
                  "same": (1, 3000, "same"), "xsorted": (2, 4096, "xsorted"),
                  "b2_n32768": (2, 32768, None), "b32": (32, 4096, None)}[case]
    return _cloud(n + b, b, n, dev, grid)


@pytest.mark.parametrize("case", ["n1024", "n1025", "n4097", "dyadic", "few", "same",
                                  "xsorted", "b2_n32768", "b32"])
def test_k5_matches_plain(cuda, case):
    """Exactly the plain version's values, through the wrapper and on the
    tiled core at every forced S; rounds 1-32 on the tiled core (24 and 32
    fill each list size), 33 on the value rounds, as the counter shows."""
    x = _phase_cloud(case, cuda)
    b, n, _ = x.shape
    for rounds in (1, 20, 24, 25, 32, 33):
        for thresh in (False, True):
            want = knn_phases.knn_phase_plain(x, rounds, thresh)
            before = knn_phases.knn_phase_cuda.launches, knn_phases.knn_phase_cuda.launches_rounds
            got = knn_phases.knn_phase(x, rounds, thresh)
            assert knn_phases.knn_phase_cuda.launches == before[0] + 1
            assert knn_phases.knn_phase_cuda.launches_rounds == before[1] + (
                rounds > TILED_MAX_K)
            assert got.dtype == torch.float32 and got.shape == (b, n)
            assert torch.equal(got, want), (rounds, thresh)
            for split in (1, 2, 4, 8) if rounds <= TILED_MAX_K else ():
                got_s, ran_rounds = knn_phases._launch_phase(x, rounds, thresh, split)
                assert not ran_rounds
                assert torch.equal(got_s, want), (rounds, thresh, split)
    if case == "few":
        assert bool(torch.isinf(knn_phases.knn_phase(x, 20)).all())


def test_k5_more_rounds_than_values(cuda):
    x = _cloud(1, 2, 33, cuda)
    for rounds in (32, 33, 34, 1000):  # 33 points: at most 33 distinct values a row
        got = knn_phases.knn_phase_cuda(x, rounds, thresh=True)
        assert torch.equal(got, knn_phases.knn_phase_plain(x, rounds, thresh=True))
        assert rounds <= 33 or bool(torch.isinf(got).all())
    with pytest.raises(RuntimeError, match="knn_phase_launch"):
        knn_phases._launch_phase(x, 33, True, 2)  # the value rounds take no S


_K6_CLOUDS = [
    (2, 1001, None),  # N % 4 != 0: every tile's bulk copy has a head and a tail
    (2, 1025, None),  # one point past a tile
    (2, 4097, None),
    (2, 4096, 8),  # ties
    (1, 3000, "same"),  # identical points
    (2, 4096, "xsorted"),  # scan order
    (1, 20000, None),  # k = 33: the warp pairs with xyz read from global memory
    (1, 32768, None),  # past the warp pairs' N limit, so k <= 32 only
]


@pytest.mark.parametrize("b,n,grid,k", [
    (b, n, grid, k) for b, n, grid in _K6_CLOUDS for k in (20, 32, 33)
    if k <= TILED_MAX_K or n <= 27700])
def test_k6_matches_plain_and_k1(cuda, b, n, grid, k):
    """The indicator equal to the plain version's and K1's, the proxy within
    1e-6 relative; k <= 32 on the tiled pipeline, also at every forced S
    (bit-equal to the wrapper's), k = 33 on the warp pairs."""
    x = _cloud(n + 5 * k, b, n, cuda, grid)
    before = (knn_phases.knn_adjacency_pipelined_cuda.launches,
              knn_phases.knn_adjacency_pipelined_cuda.launches_rounds)
    adj, proxy = knn_phases.knn_adjacency_pipelined(x, k)
    assert knn_phases.knn_adjacency_pipelined_cuda.launches == before[0] + 1
    assert knn_phases.knn_adjacency_pipelined_cuda.launches_rounds == before[1] + (
        k > TILED_MAX_K)
    adj_p, proxy_p = knn_phases.knn_adjacency_pipelined_plain(x, k)
    assert adj.dtype == torch.int8 and proxy.dtype == torch.float32
    assert torch.equal(adj, adj_p)
    del adj_p
    assert torch.equal(adj, knn.knn_adjacency_cuda(x, k, with_proxy=False)[0])
    _assert_proxy_close(proxy, proxy_p, torch.float32)
    for split in (1, 2, 4, 8) if k <= TILED_MAX_K else ():
        adj_s, proxy_s, pairs = knn_phases._launch_pipelined(x, k, split)
        assert not pairs
        assert torch.equal(adj_s, adj) and torch.equal(proxy_s, proxy), split


def test_k6_misaligned_cloud(cuda):
    """A cloud 4 bytes past a 16-byte boundary: each tile's head and tail
    go through the producer's plain loads."""
    x = _cloud(3, 2, 1001, cuda)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    assert xm.data_ptr() % 16 == 4
    adj, proxy = knn_phases.knn_adjacency_pipelined(xm, 20)
    adj_p, proxy_p = knn_phases.knn_adjacency_pipelined_plain(x, 20)
    assert torch.equal(adj, adj_p)
    _assert_proxy_close(proxy, proxy_p, torch.float32)


def test_k6_rejects_n_past_shared_memory(cuda):
    with pytest.raises(ValueError, match="shared memory"):
        knn_phases.knn_adjacency_pipelined_cuda(_cloud(0, 1, 28672, cuda), 33)


def test_shared_memory_plans(cuda):
    """Where K5's value rounds keep xyz and how far K6's warp pair fits in a
    block's 227 KB (k > 32), as the kernels' own launch plans give them."""
    assert knn_phases.xyz_in_shared_memory(16384)
    assert knn_phases.xyz_in_shared_memory(18700)
    assert not knn_phases.xyz_in_shared_memory(18800)
    assert not knn_phases.xyz_in_shared_memory(32768)
    with pytest.raises(ValueError, match="N=0"):
        knn_phases.xyz_in_shared_memory(0)
    x = _cloud(1, 1, 27700, cuda)
    adj, _ = knn_phases.knn_adjacency_pipelined_cuda(x, 33)  # the largest N that fits
    assert bool((adj.sum(-1, dtype=torch.int32) == 33).all())


def test_bf16_fullwidth_matches_jax(cuda):
    """The bf16 GEMM reduction check: the default full-width model on the
    card against JAX's descriptors computed on the CPU
    (tests/torch_bf16_fullwidth.npz, same seeded weights and clouds)."""
    data = np.load(os.path.join(os.path.dirname(__file__), "torch_bf16_fullwidth.npz"))
    x = np.random.default_rng(int(data["seed"])).uniform(-1, 1, (2, 4096, 3))
    cfg = ModelConfig()
    embed = build_embed_fn(cfg, device=cuda, variables=init_flat_variables(cfg, seed=0))
    got = embed(x.astype(np.float32)).cpu().numpy()
    gap = float(np.abs(got - data["descriptors"]).max())
    assert gap <= BF16_TOL, gap


def test_pointnetvlad_on_card(cuda):
    """Full width: finite, unit-norm descriptors at B=4, N=4096."""
    cfg = pointnetvlad_config()
    embed = build_embed_fn(cfg, device=cuda, variables=init_flat_variables(cfg, seed=0))
    d = embed(_cloud(12, 4, 4096, cuda))
    assert d.shape == (4, 256) and bool(torch.isfinite(d).all())
    assert bool(((torch.linalg.vector_norm(d, dim=-1) - 1).abs() < 1e-5).all())


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_get_recall_card_equals_cpu(cuda, quantize):
    rng = np.random.default_rng(13)
    db = rng.standard_normal((500, 256)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = db[:40] + 0.05 * rng.standard_normal((40, 256)).astype(np.float32)
    gt = [[i] for i in range(40)]
    got = get_recall(db, q, gt, quantize=quantize, device=cuda)
    want = get_recall(db, q, gt, quantize=quantize, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[0][0] == 1.0


def test_latency_probe_on_card(cuda):
    """The chained queries run as CUDA graphs: finite, positive times."""
    db = np.random.default_rng(14).standard_normal((80, 256)).astype(np.float32)
    out = retrieval_latency_probe(db, num_queries=16, device=cuda)
    assert set(out) == {"p50_ms", "p99_ms", "device_ms"}
    assert all(np.isfinite(v) for v in out.values())
    assert out["p99_ms"] >= out["p50_ms"] > 0 and out["device_ms"] > 0


# -- training on the card ------------------------------------------------------
# the golden small EPC-Net (tests/test_torch_models.py GOLDEN_KW) in fp32, the
# width of tests/torch_train_step.npz (JAX's step, written by
# tests/test_torch_train_variants.py)
GOLDEN_FP32 = dict(num_points=128, knn_k=8, proxyconv_channels=(16, 16), lift_channels=(32, 64),
                   feature_dim=64, vlad_clusters=8, vlad_groups=4, vlad_group_dim=16,
                   compute_dtype="float32")
TRAIN_STEP_FILE = os.path.join(os.path.dirname(__file__), "torch_train_step.npz")
# tests/test_torch_train_step.py TOL["fp32"] (8 seeds on the CPU)
PARITY_TOL = dict(loss=5e-6, grad=2e-4, stats=5e-6)
# the kernel path against the plain-twin path in bf16 (chip_smoke.py TRAIN_TOL)
TRAIN_TOL = dict(loss=1e-3, grad=5e-2, stats=1e-2)


def _grad_gap(got, want):
    gmax = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), 0.1 * gmax)
               for k, w in want.items())


def _stats_gap(got, want):
    return max(float(np.abs(got[k] - w).max()) for k, w in want.items()
               if k.startswith("batch_stats/"))


def _blob_batch(seed, b, p, ng, n):
    from epcnet_torch.scripts.train_bench import tuple_batch

    return tuple_batch(seed, b, p, ng, n)


def _plain_graph(model, k):
    from epcnet_torch.models.vlad_head import compute_dtype

    def build_graph(x, route):
        if route == "gather":
            return knn.knn_plain(x, k), None
        return knn.knn_adjacency_plain(x, k, compute_dtype(model.cfg), True, route)
    model.build_graph = build_graph


@pytest.mark.parametrize("both", [False, True])
def test_matmul_f32acc_backward_matches_fp32(cuda, both):
    """The card's autograd.Function against fp32 torch.matmul gradients
    rounded once to bf16: within 1 bf16 ulp."""
    from epcnet_torch.ops.matmul import matmul_f32acc

    g = torch.Generator(device=cuda).manual_seed(3)
    if both:
        x = torch.randn(4, 64, 1000, device=cuda, generator=g)
    else:  # an indicator, which takes no gradient
        x = (torch.rand(11, 1000, 1000, device=cuda, generator=g) < 0.02).float()
    y = torch.randn(x.shape[0], 1000, 48, device=cuda, generator=g)
    xb = x.bfloat16().requires_grad_(both)
    yb = y.bfloat16().requires_grad_(True)
    out = matmul_f32acc(xb, yb)
    assert out.dtype == torch.float32
    cot = torch.randn(out.shape, device=cuda, generator=g)
    out.backward(cot)
    xf = xb.detach().float().requires_grad_(both)
    yf = yb.detach().float().requires_grad_(True)
    torch.matmul(xf, yf).backward(cot)
    for got, want in [(yb.grad, yf.grad)] + ([(xb.grad, xf.grad)] if both else []):
        want_b = want.bfloat16().float()
        assert got.dtype == torch.bfloat16
        assert bool(((got.float() - want_b).abs() <= _bf16_spacing(want_b)).all())
    assert xb.grad is None if not both else xb.grad is not None


def _step_pair(cfg, tc, batch, cuda):
    from epcnet_torch.train.state import create_train_state
    from epcnet_torch.train.step import build_train_step, to_device

    flat = init_flat_variables(cfg, 0)
    batch = to_device(batch, cuda)
    kst = create_train_state(cfg, tc, cuda, variables=flat)
    pst = create_train_state(cfg, tc, cuda, variables=flat)
    _plain_graph(pst.model, cfg.knn_k)
    step = build_train_step(cfg, tc)
    before = knn.knn_adjacency_cuda.launches, knn.knn_cuda.launches
    kst, km = step(kst, batch)
    launched = (knn.knn_adjacency_cuda.launches - before[0], knn.knn_cuda.launches - before[1])
    pst, pm = step(pst, batch)
    return kst, km, pst, pm, launched


@pytest.mark.parametrize("fmt", ["dense", "gather"])
def test_train_step_kernel_path_matches_plain(cuda, fmt):
    """A small bf16 step through K1 (dense) or K2 (gather) against the same
    step on the plain twins' graph: one launch, the loss, every gradient and
    the BN statistics within TRAIN_TOL."""
    from epcnet_torch.configs import TrainConfig
    from epcnet_torch.weights import flat_grads, flat_variables

    cfg = ModelConfig(num_points=2048, knn_k=20, proxyconv_channels=(16, 16, 16, 32),
                      lift_channels=(64, 128), feature_dim=128, vlad_clusters=16,
                      vlad_groups=4, vlad_group_dim=16, adjacency_format=fmt)
    kst, km, pst, pm, launched = _step_pair(cfg, TrainConfig(), _blob_batch(5, 2, 2, 4, 2048),
                                            cuda)
    assert launched == ((1, 0) if fmt == "dense" else (0, 1))
    lk, lp = float(km["loss"]), float(pm["loss"])
    assert np.isfinite(lk) and abs(lk - lp) <= TRAIN_TOL["loss"] * abs(lp)
    assert _grad_gap(flat_grads(kst.model), flat_grads(pst.model)) <= TRAIN_TOL["grad"]
    assert _stats_gap(flat_variables(kst.model), flat_variables(pst.model)) <= TRAIN_TOL["stats"]


def test_train_step_matches_jax_file(cuda):
    """The card's fp32 step at the golden width (K1 at N=128, k=8) against
    JAX's CPU step in tests/torch_train_step.npz."""
    from epcnet_torch.configs import TrainConfig
    from epcnet_torch.train.state import create_train_state
    from epcnet_torch.train.step import build_train_step
    from epcnet_torch.weights import flat_grads, flat_variables

    data = dict(np.load(TRAIN_STEP_FILE))
    cfg = ModelConfig(**GOLDEN_FP32)
    tc = TrainConfig(learning_rate=1e-3, optimizer="momentum")
    st = create_train_state(cfg, tc, cuda, variables=init_flat_variables(cfg, int(data["seed"])))
    before = knn.knn_adjacency_cuda.launches
    st, m = build_train_step(cfg, tc)(st, {k[6:]: v for k, v in data.items()
                                           if k.startswith("batch/")})
    assert knn.knn_adjacency_cuda.launches == before + 1
    assert abs(float(m["loss"]) - float(data["loss"])) <= PARITY_TOL["loss"]
    want_g = {k[5:]: v for k, v in data.items() if k.startswith("grad/")}
    want_s = {k[6:]: v for k, v in data.items() if k.startswith("stats/")}
    assert _grad_gap(flat_grads(st.model), want_g) <= PARITY_TOL["grad"]
    assert _stats_gap(flat_variables(st.model), want_s) <= PARITY_TOL["stats"]


# ---------------------------------------------------------------------------
# Serving at scale: blocked retrieval, its memory, background sync, HTTP


def _unit_rows_on(dev, n, d=256, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=dev)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


@pytest.mark.parametrize("log2cap", [16, 18, 20])
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_blocked_retrieval_matches_full_sort(cuda, log2cap, quantize):
    """The serving path's blocked top-k equals the full-sort plain version
    (ids exactly, distances bit for bit) at capacities 2^16-2^20, with
    duplicate rows in different blocks (ties to the lowest index) and a
    far-padded tail."""
    from epcnet_torch.ops import retrieval as ret

    cap = 1 << log2cap
    db = _unit_rows_on(cuda, cap, seed=log2cap)
    dup = torch.unique(torch.tensor([7, 65536 + 7, cap // 2 + 3, cap - 4097], device=cuda) % cap)
    db[dup] = db[5].clone()
    db[cap - 4096:] = 1e6
    q = torch.cat([db[:4], db[5:6], _unit_rows_on(cuda, 27, seed=1)])
    if quantize == "int8":
        qi, sc = ret.quantize_descriptors(db)
        got = ret.topk_neighbors_quantized(q, qi, sc, 25)
        want = ret.topk_neighbors_quantized_plain(q, qi, sc, 25)
    else:
        got = ret.topk_neighbors(q, db, 25)
        want = ret.topk_neighbors_plain(q, db, 25)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0][4, :len(dup) + 1].tolist() == sorted([5] + dup.tolist())


def test_int8_query_transient_bound(cuda):
    """One padded query batch (32) against a 2^20-capacity int8 index
    allocates less than the resident DB's 268 MB beyond what was resident."""
    ix = PlaceIndex(None, 256, embed_batch=32, quantize="int8", device=cuda)
    ix.add_descriptors(_unit_rows_on(cuda, (1 << 20) - 1000).cpu().numpy())
    ix.flush()
    assert ix.metrics()["device_rows_capacity"] == 1 << 20
    q = _unit_rows_on(cuda, 32, seed=2).cpu().numpy()
    ix.query_descriptors(q, k=25)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ids, _ = ix.query_descriptors(q, k=25)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < (1 << 20) * 256
    assert ids.shape == (32, 25)


def _ingest_under_queries(ix, d) -> None:
    """8 threads query ``ix`` (background sync) while ``d`` is added: every
    answer is the exact top-1 of a prefix no shorter than the one visible
    when it was sent; flush() makes every row visible."""
    import threading

    ix.add_descriptors(d[:4096])
    ix.flush()
    errors = []

    def worker(seed):
        r = np.random.default_rng(seed)
        for _ in range(40):
            j = int(r.integers(len(d)))
            lo = ix.metrics()["device_synced_rows"]
            ids, dist = ix.query_descriptors(d[j:j + 1], k=1)
            hi = ix.metrics()["device_synced_rows"]
            if (j < lo and ids[0, 0] != j) or ids[0, 0] >= hi:
                errors.append((j, lo, hi, int(ids[0, 0])))

    pool = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in pool:
        t.start()
    for s in range(4096, len(d), 50_000):
        ix.add_descriptors(d[s:s + 50_000])
    for t in pool:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in pool) and not errors, errors[:3]
    ix.flush()
    assert ix.metrics()["device_synced_rows"] == len(d)
    ids, _ = ix.query_descriptors(d[-8:], k=1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(len(d) - 8, len(d)))


def test_background_ingest_consistent_prefixes(cuda):
    """Background sync on its own stream while 8 threads query
    (``_ingest_under_queries``)."""
    d = _unit_rows_on(cuda, 300_000, seed=3).cpu().numpy()
    _ingest_under_queries(PlaceIndex(None, 256, embed_batch=8, sync_mode="background",
                                     device=cuda), d)


def test_sharded_background_ingest_consistent_prefixes(cuda):
    """The same over two shards on one card: one side stream for the one
    device, each chunk staged in pinned memory, an event a device."""
    from epcnet_torch.configs import MeshConfig
    from epcnet_torch.parallel import make_mesh

    mesh = make_mesh(MeshConfig(data_axis=1, db_axis=2), ["cuda:0", "cuda:0"])
    d = _unit_rows_on(cuda, 300_000, seed=4).cpu().numpy()
    ix = PlaceIndex(None, 256, embed_batch=8, sync_mode="background", mesh=mesh)
    assert len(ix._streams) == 1
    _ingest_under_queries(ix, d)
    assert ix._staging.is_pinned() and len(ix._dev_ready) == 1


def test_http_server_on_card(cuda):
    """The CLI's server over a small model on the card: /add, concurrent
    /query self-retrieval, /metrics, a 400 and a 404."""
    import json
    import threading
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from epcnet_torch.cli.serve import make_server

    cfg = ModelConfig(num_points=1024, knn_k=20, proxyconv_channels=(16, 16, 16, 32),
                      lift_channels=(64, 128), feature_dim=128, vlad_clusters=16,
                      vlad_groups=4, vlad_group_dim=16)
    embed = build_embed_fn(cfg, cuda, variables=init_flat_variables(cfg, 0))
    ix = PlaceIndex(embed, cfg.output_dim, embed_batch=8, num_points=1024, device=cuda)
    ix.warmup()
    srv, sched = make_server(ix, port=0, k=5, max_wait_ms=10.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def call(path, payload=None):
        req = urllib.request.Request(base + path, None if payload is None else
                                     json.dumps(payload).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        pts = _cloud(11, 12, 1024, None).cpu().numpy()
        before = knn.knn_adjacency_cuda.launches
        assert call("/add", {"points": pts.tolist(), "metadata": list(range(12))}) == \
            (200, {"size": 12})
        with ThreadPoolExecutor(8) as ex:
            res = list(ex.map(lambda i: call("/query", {"points": pts[i].tolist(), "k": 3}),
                              range(12)))
        for i, (code, r) in enumerate(res):
            assert code == 200 and r["ids"][0] == i and r["metadata"][0] == i
        assert knn.knn_adjacency_cuda.launches > before
        code, m = call("/metrics")
        assert code == 200 and m["index"]["size"] == 12 and m["scheduler"]["errors"] == 0
        assert call("/query", {"points": pts[0].tolist(), "k": 6})[0] == 400
        assert call("/nowhere")[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()
        sched.stop()


# -- the multi-device slice on one card ---------------------------------------


def test_two_shard_retrieval_on_one_card(cuda):
    """Sharded and ring top-k over [cuda:0, cuda:0] (fp32 and int8) and a
    sharded PlaceIndex: the unsharded answers exactly."""
    from epcnet_torch.configs import MeshConfig
    from epcnet_torch.ops.retrieval import (
        quantize_descriptors,
        ring_topk_neighbors,
        sharded_topk_neighbors,
        topk_neighbors,
        topk_neighbors_quantized,
    )
    from epcnet_torch.parallel import make_mesh

    mesh = make_mesh(MeshConfig(data_axis=1, db_axis=2), ["cuda:0", "cuda:0"])
    gen = torch.Generator(device=cuda).manual_seed(3)
    db = torch.nn.functional.normalize(torch.randn(300_001, 256, device=cuda, generator=gen),
                                       dim=-1)
    q = db[::10_000] + 1e-3
    want, _ = topk_neighbors(q, db, 25)
    for fn in (sharded_topk_neighbors, ring_topk_neighbors):
        got, _ = fn(q, db, 25, mesh)
        assert torch.equal(got, want), fn.__name__
    qi, sc = quantize_descriptors(db)
    want_q, _ = topk_neighbors_quantized(q, qi, sc, 25)
    got_q, _ = sharded_topk_neighbors(q, qi, 25, mesh, db_scale=sc)
    assert torch.equal(got_q, want_q)
    one = PlaceIndex(None, descriptor_dim=256, embed_batch=32, device=cuda)
    two = PlaceIndex(None, descriptor_dim=256, embed_batch=32, mesh=mesh)
    host = db[:20_000].cpu().numpy()
    for ix in (one, two):
        ix.add_descriptors(host)
    np.testing.assert_array_equal(two.query_descriptors(host[::997], k=5)[0],
                                  one.query_descriptors(host[::997], k=5)[0])
    assert two.metrics()["sharded"]


def test_staged_gloo_collectives_of_cuda_tensors(cuda, tmp_path):
    """Two gloo ranks on the card: the ring shift (staged through host
    memory) and all_gather / all_reduce / broadcast (gloo's own CUDA path)
    give the plain values, and the results stay on the card."""
    from torch_dist_worker import spawn

    for o in spawn("cuda_collectives", 2, str(tmp_path), timeout=120):
        assert all(bool(v) for v in o.values()), o
