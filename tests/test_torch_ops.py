"""The port's op twins against the JAX package on the CPU: the same numpy
inputs, made from a seed, through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu.ops import adjacency as jadj
from epcnet_tpu.ops import retrieval as jret
from epcnet_tpu.ops import vlad as jvlad
from epcnet_tpu.ops.knn import knn_jnp
from epcnet_tpu.ops.pairwise import pairwise_sqdist as j_pairwise

from epcnet_torch.ops import adjacency as tadj
from epcnet_torch.ops import retrieval as tret
from epcnet_torch.ops import vlad as tvlad
from epcnet_torch.ops.knn import knn_plain
from epcnet_torch.ops.pairwise import pairwise_sqdist

BF16_ULP = 2.0 ** -7  # bf16 keeps 8 significant bits


def _t(a):
    return torch.tensor(np.asarray(a))


def _within_bf16_ulps(got, want, ulps=1):
    """|got - want| <= ulps * (bf16 spacing at |want|), elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    spacing = BF16_ULP * 2.0 ** np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    return np.all(np.abs(got - want) <= ulps * spacing)


def test_pairwise_sqdist_bit_equal():
    x = np.random.RandomState(1).randn(2, 500, 3).astype(np.float32)
    np.testing.assert_array_equal(pairwise_sqdist(_t(x)).numpy(),
                                  np.asarray(j_pairwise(jnp.asarray(x))))


def test_pairwise_sqdist_wide_norm_expansion():
    x = np.random.RandomState(2).randn(2, 40, 16).astype(np.float32)
    y = np.random.RandomState(3).randn(2, 30, 16).astype(np.float32)
    got = pairwise_sqdist(_t(x), _t(y)).numpy()
    want = np.asarray(j_pairwise(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert got.min() >= 0.0


def _knn_cases():
    rng = np.random.RandomState(4)
    ties = np.zeros((1, 16, 3), np.float32)
    ties[0, :, 0] = np.repeat(np.arange(8), 2)  # tests/test_knn.py:47
    return {
        "random64": (rng.randn(2, 64, 3).astype(np.float32), 4),
        "random300": (rng.randn(2, 300, 3).astype(np.float32), 10),
        "pairs_tied": (ties, 4),
        "all_identical": (np.ones((1, 40, 3), np.float32), 5),  # :94
        "k_equals_n": (rng.randn(1, 32, 3).astype(np.float32), 32),
    }


@pytest.mark.parametrize("case", sorted(_knn_cases()))
def test_knn_plain_matches_knn_jnp(case):
    x, k = _knn_cases()[case]
    idx, dist = knn_plain(_t(x), k, return_dists=True)
    jidx, jdist = knn_jnp(jnp.asarray(x), k, return_dists=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    if case == "all_identical":
        np.testing.assert_array_equal(idx[0, 0].numpy(), np.arange(5))


def test_count_adjacency_matches():
    rng = np.random.RandomState(5)
    idx = rng.randint(0, 300, (2, 300, 9)).astype(np.int32)  # repeats counted
    got = tadj.count_adjacency(_t(idx), 300).numpy()
    np.testing.assert_array_equal(got, np.asarray(jadj.count_adjacency(jnp.asarray(idx), 300)))


@pytest.mark.parametrize("n", [200, 300])  # JAX's direct route (n <= 256) and its hi/lo route
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mean_adjacency_bit_equal(dtype, n):
    rng = np.random.RandomState(n)
    idx = rng.randint(0, n, (2, n, 7)).astype(np.int32)
    idx[:, :, 3] = idx[:, :, 1]  # duplicated ids: counted with multiplicity
    want = jadj.mean_adjacency(jnp.asarray(idx), n, jnp.dtype(dtype))
    got = tadj.mean_adjacency(_t(idx), n, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, n, n)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    dup = got.float().gather(-1, _t(idx[:, :, 1:2]).long())  # at least 2 of 7 in each row
    assert bool((dup >= torch.tensor(2 / 7).to(got.dtype).float()).all())


# JAX names whose port counterpart has another name; ``knn`` stays a name of
# the submodule (``epcnet_torch/ops/__init__.py``)
_RENAMED = {"knn_pallas": "knn.knn_cuda", "knn_jnp": "knn.knn_plain",
            "knn_with_adjacency_pallas": "knn.knn_adjacency_cuda",
            "vlad_aggregate_jnp": "vlad.vlad_aggregate", "knn": "knn.knn"}


def test_every_jax_op_has_a_port_export():
    import importlib

    import epcnet_tpu.ops as jops

    import epcnet_torch.ops as tops

    for name in jops.__all__:
        if name not in _RENAMED:
            assert name in tops.__all__, name
            continue
        mod, attr = _RENAMED[name].split(".")
        owner = importlib.import_module(f"epcnet_torch.ops.{mod}")
        assert callable(getattr(owner, attr)), name
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neighbor_mean_matches(dtype):
    rng = np.random.RandomState(6)
    k = 7
    x = rng.randn(2, 120, 3).astype(np.float32)
    ind = np.asarray(jadj.count_adjacency(knn_jnp(jnp.asarray(x), k), 120, jnp.int8))
    f = rng.randn(2, 120, 24).astype(np.float32)
    jf = jnp.asarray(f).astype(dtype)
    want = np.asarray(jadj.neighbor_mean(jf, adjacency=jnp.asarray(ind),
                                         compute_dtype=jnp.dtype(dtype),
                                         adjacency_scale=1.0 / k).astype(jnp.float32))
    tf = _t(f).to(getattr(torch, dtype))
    got = tadj.neighbor_mean(tf, _t(ind), getattr(torch, dtype), 1.0 / k)
    assert got.dtype == tf.dtype
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:  # an fp32 sum in another order may round to the neighbouring bf16
        assert _within_bf16_ulps(got, want)


def _vlad_inputs(seed, mask=False):
    rng = np.random.RandomState(seed)
    f = rng.randn(3, 50, 16).astype(np.float32)
    logits = (2 * rng.randn(3, 50, 6)).astype(np.float32)
    cent = rng.randn(6, 16).astype(np.float32) * 0.25
    m = (rng.uniform(size=(3, 50)) > 0.3).astype(np.float32) if mask else None
    return f, logits, cent, m


@pytest.mark.parametrize("mask", [False, True])
def test_vlad_aggregate_highest_matches(mask):
    f, logits, cent, m = _vlad_inputs(7, mask)
    want = np.asarray(jvlad.vlad_aggregate(
        jnp.asarray(f), jnp.asarray(logits), jnp.asarray(cent),
        mask=None if m is None else jnp.asarray(m)))
    got = tvlad.vlad_aggregate(_t(f), _t(logits), _t(cent),
                               mask=None if m is None else _t(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_vlad_aggregate_default_precision():
    """precision="default": bf16 operands, fp32 sum. Exact against the same
    arithmetic spelled out (bf16-rounded Aᵀ and X into the JAX tail), and
    within bf16 drift of the fp32 result."""
    f, logits, cent, _ = _vlad_inputs(8)
    a = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    rb = lambda v: np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    s = np.einsum("bnc,bnd->bcd", rb(a), rb(f))
    want = np.asarray(jvlad._finish(jnp.asarray(s), jnp.asarray(a.sum(-2)),
                                    jnp.asarray(cent), 1e-12))
    got = tvlad.vlad_aggregate(_t(f), _t(logits), _t(cent), precision="default").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    fp32 = np.asarray(jvlad.vlad_aggregate(jnp.asarray(f), jnp.asarray(logits),
                                           jnp.asarray(cent)))
    np.testing.assert_allclose(got, fp32, atol=2e-2)
    with pytest.raises(ValueError, match="precision"):
        tvlad.vlad_aggregate(_t(f), _t(logits), _t(cent), precision="fast")


def _unit_rows(rng, n, d=32):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_retrieval_fp32_matches():
    rng = np.random.RandomState(9)
    db = _unit_rows(rng, 300)
    db[200:210] = db[3]  # exact duplicates: ties resolve to the lowest index
    q = np.concatenate([db[:5], _unit_rows(rng, 11)])
    np.testing.assert_allclose(
        tret.l2_distance_matrix(_t(q), _t(db)).numpy(),
        np.asarray(jret.l2_distance_matrix(jnp.asarray(q), jnp.asarray(db))),
        rtol=1e-5, atol=1e-6)
    ids, d = tret.topk_neighbors(_t(q), _t(db), 12)
    jids, jd = jret.topk_neighbors(jnp.asarray(q), jnp.asarray(db), 12)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ids[3, :11].numpy(), [3, *range(200, 210)])


def test_retrieval_int8_matches():
    rng = np.random.RandomState(10)
    db = _unit_rows(rng, 200)
    q = db[:20]
    qi, sc = tret.quantize_descriptors(_t(db))
    jqi, jsc = jret.quantize_descriptors(jnp.asarray(db))
    assert qi.dtype == torch.int8
    np.testing.assert_array_equal(qi.numpy(), np.asarray(jqi))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tret.dequantize_descriptors(qi, sc).numpy(),
                                  np.asarray(jret.dequantize_descriptors(jqi, jsc)))
    np.testing.assert_allclose(
        tret.quantized_distance_matrix(_t(q), qi, sc).numpy(),
        np.asarray(jret.quantized_distance_matrix(jnp.asarray(q), jqi, jsc)),
        rtol=1e-5, atol=1e-5)
    ids, _ = tret.topk_neighbors_quantized(_t(q), qi, sc, 5)
    jids, _ = jret.topk_neighbors_quantized(jnp.asarray(q), jqi, jsc, 5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(20))


def test_pack_unpack_indicator_match():
    """[2, 96, 256] at 5% density with plane 31 (the int32 sign bit) hit:
    the port's planes equal the JAX ones and unpack back to the indicator."""
    rng = np.random.RandomState(11)
    ind = (rng.rand(2, 96, 256) < 0.05).astype(np.int8)
    ind[:, 3, 31 * 8 + 5] = 1  # column j*W + w with j = 31, W = 8
    packed = tadj.pack_indicator(_t(ind))
    want = np.asarray(jadj.pack_indicator(jnp.asarray(ind)))
    assert packed.dtype == torch.int32 and packed.shape == (2, 96, 8)
    np.testing.assert_array_equal(packed.numpy(), want)
    assert bool((packed[:, 3, 5] < 0).all())
    for dt, jdt in ((torch.int8, jnp.int8), (torch.float32, jnp.float32)):
        back = tadj.unpack_indicator(packed, dt)
        assert back.dtype == dt
        np.testing.assert_array_equal(back.numpy(), ind.astype(back.numpy().dtype))
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jadj.unpack_indicator(jnp.asarray(want), jdt)))
    with pytest.raises(ValueError, match="divisible by 32"):
        tadj.pack_indicator(torch.zeros(2, 3, 100))


def _packed_case(seed, k, n, c, density):
    """Planes of a kNN graph (density None; "empty_rows": every third row
    cleared) or of a random mask, and features. Past 5% density every row
    holds a column of plane 31, and the features lie on a grid of 1/64 in
    [-4, 4], so that any order of a row's fp32 sum (128 terms at half
    density) is exact and the stated tolerance still measures the walk."""
    rng = np.random.RandomState(seed)
    if density in (None, "empty_rows"):
        ind = np.asarray(jadj.count_adjacency(
            knn_jnp(jnp.asarray(rng.randn(2, n, 3).astype(np.float32)), k), n, jnp.int8))
        if density == "empty_rows":
            ind = ind.copy()
            ind[:, ::3] = 0
    else:
        ind = (rng.rand(2, n, n) < density).astype(np.int8)
        if density > 0.05:
            ind[:, :, 31 * (n // 32)] = 1  # plane 31, the int32 sign bit
    packed = np.asarray(jadj.pack_indicator(jnp.asarray(ind)))
    f = rng.randn(2, n, c).astype(np.float32)
    if density not in (None, "empty_rows") and density > 0.05:
        f = np.clip(np.round(f * 64) / 64, -4, 4).astype(np.float32)
    return packed, f


@pytest.mark.parametrize("density", [None, 0.05, "empty_rows", 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_neighbor_mean_matches(dtype, density):
    """K4's plain version against the JAX ``packed_neighbor_mean`` on its jnp
    route and its Pallas kernel in interpret mode (tests/test_ops.py:172),
    for a kNN graph (k bits a row), one with rows that hold no bit, a
    5%-dense mask (any popcount) and a half-dense one with plane 31 set in
    every row."""
    k, n, c = 6, 256, 48
    packed, f = _packed_case(12, k, n, c, density)
    jd = jnp.dtype(dtype)
    jf = jnp.asarray(f).astype(jd)
    tf = _t(f).to(getattr(torch, dtype))
    got = tadj.packed_neighbor_mean(tf, _t(packed), k, getattr(torch, dtype))
    assert got.dtype == tf.dtype and got.shape == (2, n, c)
    got = got.float().numpy()
    for impl in ("jnp", "pallas"):
        want = np.asarray(jadj.packed_neighbor_mean(
            jf, jnp.asarray(packed), k, impl=impl, interpret=True, dtype=jd
        ).astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=impl)
        else:  # an fp32 sum in another order may round to the neighbouring bf16
            assert _within_bf16_ulps(got, want), impl
    with pytest.raises(ValueError, match="packed columns"):
        tadj.packed_neighbor_mean(tf[:, :100], _t(packed), k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_neighbor_mean_matches(dtype):
    """The gather route's mean against the JAX ``gather_neighbor_mean``, from
    int32 ids, with leading dims [2, 3]."""
    rng = np.random.RandomState(13)
    k = 9
    x = rng.randn(2, 3, 150, 3).astype(np.float32)
    idx = np.asarray(knn_jnp(jnp.asarray(x), k))
    f = rng.randn(2, 3, 150, 40).astype(np.float32)
    jf = jnp.asarray(f).astype(dtype)
    want = np.asarray(jadj.gather_neighbor_mean(jf, jnp.asarray(idx)).astype(jnp.float32))
    tf = _t(f).to(getattr(torch, dtype))
    got = tadj.gather_neighbor_mean(tf, _t(idx))
    assert got.dtype == tf.dtype and got.shape == (2, 3, 150, 40)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert _within_bf16_ulps(got, want)
    # the same neighbour sets through the dense indicator: the same means
    ind = tadj.count_adjacency(_t(idx), 150)
    dense = tadj.neighbor_mean(_t(f), ind, torch.float32, 1.0 / k).numpy()
    np.testing.assert_allclose(tadj.gather_neighbor_mean(_t(f), _t(idx)).numpy(), dense,
                               rtol=1e-5, atol=1e-6)
