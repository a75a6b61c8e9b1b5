"""The port's model against the JAX package on the CPU: weights from a JAX
``init`` -> ``flatten_variables`` -> ``load_flat_variables``, BN running
stats overwritten with seeded values so that BN does real work, the same
numpy clouds through both.

Tolerances: fp32 descriptors agree to 1e-5 max abs. Under bf16 the two
frameworks round the same bf16 products after sums taken in another order;
over 16 seeds (inputs scaled 0.5-20x) the worst gap measured was 1.8e-5 for
epcnet and 4.9e-6 for epcnet_l, so bf16 is held to 2e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu import configs as jcfg
from epcnet_tpu.cli.export import flatten_variables
from epcnet_tpu.models import get_model as j_get_model
from epcnet_tpu.models.layers import ProxyConv as JProxyConv
from epcnet_tpu.models.layers import SharedMLP as JSharedMLP
from epcnet_tpu.models.layers import TNet as JTNet
from epcnet_tpu.models.vlad_head import GVLADHead as JGVLADHead
from epcnet_tpu.ops.knn import packed_layout_supported

from epcnet_torch import configs as tcfg
from epcnet_torch.models import PointNetVLAD, get_model, param_count
from epcnet_torch.models.epcnet import _packed_layout_supported, adjacency_route
from epcnet_torch.models.layers import ProxyConv, SharedMLP, TNet
from epcnet_torch.models.vlad_head import GVLADHead
from epcnet_torch.ops.adjacency import neighbor_mean
from epcnet_torch.weights import init_flat_variables, load_flat_variables

FP32_TOL = 1e-5
BF16_TOL = 2e-4
GATHER_FP32_TOL = 2e-5  # tests/test_models.py:207, gather against dense

# tests/test_golden.py:35-42
GOLDEN_KW = {
    "epcnet": dict(num_points=128, knn_k=8, use_pallas=False,
                   proxyconv_channels=(16, 16), lift_channels=(32, 64),
                   feature_dim=64, vlad_clusters=8, vlad_groups=4,
                   vlad_group_dim=16),
    "epcnet_l": dict(num_points=128, knn_k=8, use_pallas=False,
                     proxyconv_channels=(8, 8), lift_channels=(16, 32),
                     feature_dim=32, vlad_clusters=4, vlad_groups=2,
                     vlad_group_dim=8),
    "pointnetvlad": dict(num_points=128, use_pallas=False, vlad_clusters=8,
                         feature_dim=64, pointnet_channels=(16, 16, 16, 32, 64),
                         vlad_group_dim=256),
}
# PointNetVLAD at the published widths (pointnetvlad_config()), from
# jax.eval_shape of the JAX model (test_pointnetvlad_full_width_params)
PNV_PARAMS = 19_786_505


def _cfgs(name, **kw):
    kw = {**GOLDEN_KW.get(name, {}), **kw}
    if name == "epcnet_l":
        return jcfg.epcnet_l_config(**kw), tcfg.epcnet_l_config(**kw)
    if name == "pointnetvlad":
        return jcfg.pointnetvlad_config(**kw), tcfg.pointnetvlad_config(**kw)
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def _seeded_stats(batch_stats, rng):
    """mean ~ N(0, 0.1^2), var ~ U(0.5, 1.5), in the tree's order."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
             else rng.normal(0.0, 0.1, a.shape)).astype(np.float32)),
        batch_stats)


def _seeded_transforms(params, rng):
    """A T-Net's transform_w (zeros at a flax init) ~ N(0, (0.1/16)^2), so
    that each transform does real work."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rng.normal(0.0, 0.1 / 16, a.shape).astype(np.float32))
        if p[-1].key == "transform_w" else a, params)


def _both(name, seed, x, stats=True, **kw):
    jc, tc = _cfgs(name, **kw)
    jm = j_get_model(jc)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    if stats:
        rng = np.random.RandomState(seed)
        v = {"params": _seeded_transforms(v["params"], rng),
             "batch_stats": _seeded_stats(v["batch_stats"], rng)}
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = get_model(tc, device="cpu")
    load_flat_variables(tm, flatten_variables(v["params"], v.get("batch_stats")))
    with torch.inference_mode():
        got = tm(torch.tensor(x)).numpy()
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["epcnet", "epcnet_l"])
def test_model_matches_jax(name, dtype):
    x = np.random.RandomState(21).uniform(-1, 1, (2, 128, 3)).astype(np.float32)
    got, want = _both(name, 3, x, compute_dtype=dtype)
    assert got.shape == (2, 256) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("name", ["epcnet", "epcnet_l", "pointnetvlad"])
def test_golden_descriptors_reproduced(name):
    """tests/golden_descriptors.npz (JAX init from PRNGKey(7), bf16)."""
    golden = np.load("tests/golden_descriptors.npz")[name]
    x = np.random.RandomState(12345).uniform(-1, 1, (2, 128, 3)).astype(np.float32)
    got, _ = _both(name, 7, x, stats=False)
    np.testing.assert_allclose(got, golden, atol=BF16_TOL, rtol=0)


def test_full_width_fp32():
    """The default ModelConfig's widths (2,742,144 params) at N=512, B=1."""
    x = np.random.RandomState(22).uniform(-1, 1, (1, 512, 3)).astype(np.float32)
    got, want = _both("epcnet", 5, x, num_points=512, compute_dtype="float32")
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("groups,group_dim,dtype", [
    (4, 16, "float32"), (4, 16, "bfloat16"), (1, 256, "float32"),
])
def test_gvlad_head_matches(groups, group_dim, dtype):
    """Grouped FC + out_fc, and the G=1 / group_dim=output_dim skip."""
    kw = dict(feature_dim=24, vlad_clusters=6, vlad_groups=groups,
              vlad_group_dim=group_dim, compute_dtype=dtype)
    jc, tc = _cfgs("epcnet", **kw)
    f = np.random.RandomState(23).randn(3, 40, 24).astype(np.float32)
    head = JGVLADHead(jc)
    v = head.init(jax.random.PRNGKey(1), jnp.asarray(f), False, 0.9)
    want = np.asarray(head.apply(v, jnp.asarray(f), False, 0.9))
    th = GVLADHead(tc)
    assert th.skip_out_fc == (groups == 1) and hasattr(th, "out_fc") != (groups == 1)
    load_flat_variables(th, flatten_variables(v["params"], None))
    with torch.inference_mode():
        got = th(torch.tensor(f)).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proxyconv_and_shared_mlp_match(dtype):
    rng = np.random.RandomState(24)
    n, k = 60, 5
    f = rng.randn(2, n, 8).astype(np.float32)
    ind = np.zeros((2, n, n), np.int8)
    for b in range(2):
        for i in range(n):
            ind[b, i, rng.choice(n, k, replace=False)] = 1
    jd = jnp.dtype(dtype)
    jf = jnp.asarray(f).astype(jd)
    pc, mlp = JProxyConv(12, knn_k=k, dtype=jd), JSharedMLP((16, 10), dtype=jd)
    vp = pc.init(jax.random.PRNGKey(2), jf, jnp.asarray(ind), False, 0.9)
    vp = {"params": vp["params"], "batch_stats": _seeded_stats(vp["batch_stats"], rng)}
    h = pc.apply(vp, jf, jnp.asarray(ind), False, 0.9)
    vm = mlp.init(jax.random.PRNGKey(3), h, False, 0.9)
    vm = {"params": vm["params"], "batch_stats": _seeded_stats(vm["batch_stats"], rng)}
    want = np.asarray(mlp.apply(vm, h, False, 0.9).astype(jnp.float32))

    td = getattr(torch, dtype)
    tpc, tmlp = ProxyConv(8, 12, td), SharedMLP(12, (16, 10), td)
    load_flat_variables(tpc, flatten_variables(vp["params"], vp["batch_stats"]))
    load_flat_variables(tmlp, flatten_variables(vm["params"], vm["batch_stats"]))
    tf = torch.tensor(f).to(td)
    proxy = neighbor_mean(tf, torch.tensor(ind), compute_dtype=td, adjacency_scale=1.0 / k)
    with torch.inference_mode():
        th = tpc(tf, proxy)
        got = tmlp(th)
    assert got.dtype == td
    # bf16 activations here are O(1), not unit-normalised: 2e-2 is ~2 bf16 ulps
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=FP32_TOL if dtype == "float32" else 2e-2)
    # train mode: batch statistics, as the flax modules' mutable apply
    want_h = pc.apply(vp, jf, jnp.asarray(ind), True, 0.7, mutable=["batch_stats"])[0]
    want_t = mlp.apply(vm, want_h, True, 0.7, mutable=["batch_stats"])[0].astype(jnp.float32)
    with torch.no_grad():
        got_t = tmlp(tpc(tf, proxy, train=True, momentum=0.7), train=True, momentum=0.7)
    np.testing.assert_allclose(got_t.float().numpy(), np.asarray(want_t),
                               atol=FP32_TOL if dtype == "float32" else 2e-2)


def test_adjacency_routes_follow_jax():
    for n in [128, 4096, 16384, 16385, 20000, 20480, 32768, 32769]:
        for dt in ("bfloat16", "float32"):
            assert _packed_layout_supported(n, dt) == packed_layout_supported(n, proxy_dtype=dt), (n, dt)
    _, tc = _cfgs("epcnet")
    assert adjacency_route(tc, 4096) == "dense"
    assert adjacency_route(tc, 20480) == "packed"
    assert adjacency_route(tc, 20000) == "dense"  # packed layout refuses 20000
    assert adjacency_route(tc, 40000) == "gather"
    assert adjacency_route(tc.variant(adjacency_format="dense"), 40000) == "dense"
    # training: gather AT N=32768, never packed (K4 has no backward)
    assert adjacency_route(tc, 32768) == "packed"
    assert adjacency_route(tc, 32768, train=True) == "gather"
    assert adjacency_route(tc, 32767, train=True) == "dense"
    assert adjacency_route(tc, 20480, train=True) == "dense"
    assert adjacency_route(tc, 40000, train=True) == "gather"
    assert adjacency_route(tc.variant(adjacency_format="packed"), 4096, train=True) == "dense"
    assert adjacency_route(tc.variant(adjacency_format="gather"), 128, train=True) == "gather"
    x = torch.tensor(np.random.RandomState(26).uniform(-1, 1, (1, 128, 3)).astype(np.float32))
    outs = {}
    for fmt in ("dense", "packed", "gather"):  # both capacity routes run
        m = get_model(tc.variant(adjacency_format=fmt), device="cpu")
        load_flat_variables(m, init_flat_variables(tc, seed=1))
        with torch.inference_mode():
            outs[fmt] = m(x)
    assert torch.equal(outs["packed"], outs["dense"])  # the same twins' sums
    np.testing.assert_allclose(outs["gather"], outs["dense"], atol=BF16_TOL, rtol=0)
    with pytest.raises(ValueError, match="divisible by 32"):
        m = get_model(tc.variant(adjacency_format="packed"), device="cpu")
        m(torch.zeros(1, 100, 3))
    with pytest.raises(ValueError, match="adjacency_format"):
        tcfg.ModelConfig(adjacency_format="pakced")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["packed", "gather"])
def test_capacity_routes_match_jax(fmt, dtype):
    """The packed and gather routes against the JAX model on the same route,
    at the tiny_model_cfg shapes (tests/conftest.py:35)."""
    x = np.random.RandomState(25).uniform(-1, 1, (2, 128, 3)).astype(np.float32)
    got, want = _both("epcnet", 4, x, adjacency_format=fmt, compute_dtype=dtype)
    assert got.shape == (2, 256) and np.isfinite(got).all()
    tol = BF16_TOL if dtype == "bfloat16" else (FP32_TOL if fmt == "packed" else GATHER_FP32_TOL)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_auto_switches_routes_spied(monkeypatch):
    """``auto`` past the cutovers takes the packed, then the gather route,
    with the dense route's descriptors (tests/test_models.py:149-181 and
    :236-261): packed bit for bit through the plain twins, gather to 2e-5."""
    import epcnet_torch.models.epcnet as mod

    seen = []
    real_adj, real_knn = mod.knn_adjacency, mod.knn
    monkeypatch.setattr(mod, "knn_adjacency",
                        lambda *a, **kw: seen.append(kw["fmt"]) or real_adj(*a, **kw))
    monkeypatch.setattr(mod, "knn", lambda *a, **kw: seen.append("knn") or real_knn(*a, **kw))
    _, tc = _cfgs("epcnet", compute_dtype="float32")
    m = get_model(tc, device="cpu")
    load_flat_variables(m, init_flat_variables(tc, seed=2))
    x = torch.tensor(np.random.RandomState(27).randn(2, 128, 3).astype(np.float32))
    with torch.inference_mode():
        out_dense = m(x)
        assert seen == ["dense"]
        monkeypatch.setattr(mod, "_PACKED_AUTO_N", 127)
        out_packed = m(x)
        assert seen[-1] == "packed"
        monkeypatch.setattr(mod, "_GATHER_AUTO_N", 127)
        out_gather = m(x)
        assert seen[-1] == "knn"
    assert torch.equal(out_packed, out_dense)
    np.testing.assert_allclose(out_gather, out_dense, atol=GATHER_FP32_TOL, rtol=0)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("fmt", ["auto", "dense", "packed", "gather"])
def test_route_choice_matches_jax_model(fmt, monkeypatch):
    """For each adjacency_format and N the port's forward builds the graph
    the JAX model's __call__ builds. Both packages' cutovers are moved to
    N=100 and N=200 so that every branch is met at small N; the spies stop
    each forward at its graph."""
    import epcnet_tpu.models.epcnet as jmod

    import epcnet_torch.models.epcnet as tmod

    seen = []

    def stop(tag):
        def spy(*a, **kw):
            seen.append(kw.get("fmt", tag))
            raise _Stop
        return spy

    for mod in (jmod, tmod):
        monkeypatch.setattr(mod, "_PACKED_AUTO_N", 100)
        monkeypatch.setattr(mod, "_GATHER_AUTO_N", 200)
        monkeypatch.setattr(mod, "knn_adjacency", stop("dense"))
        monkeypatch.setattr(mod, "knn", stop("gather"))
    jc, tc = _cfgs("epcnet", adjacency_format=fmt)
    jm, tm = j_get_model(jc), get_model(tc, device="cpu")
    # 96: packed layout refused; 128: accepted; 192: refused; 200: the
    # gather cutover itself (training takes gather there); 256, 320 > 200
    for train in (False, True):
        for n in (96, 128, 192, 200, 256, 320):
            with pytest.raises(_Stop):
                jm.init(jax.random.PRNGKey(0), jnp.zeros((1, n, 3)), train=train)
            with pytest.raises(_Stop):
                tm(torch.zeros(1, n, 3), train=train)
            assert seen[-1] == seen[-2] == adjacency_route(tc, n, train), (fmt, n, train, seen)


def test_get_model_names():
    pnv = get_model(tcfg.pointnetvlad_config(), device="cpu")
    assert isinstance(pnv, PointNetVLAD) and not pnv.training
    assert param_count(pnv) == PNV_PARAMS
    with pytest.raises(ValueError, match="unknown model"):
        get_model(tcfg.ModelConfig(name="dgcnn"), device="cpu")
    m = get_model(tcfg.ModelConfig(), device="cpu")
    assert sum(p.numel() for p in m.parameters()) == 2_742_144
    # both run in train mode, with JAX's train-mode outputs (batch
    # statistics); fp32 at B=4, N=64: over 8 seeds the worst gaps were 6.0e-6
    # (PointNetVLAD, whose T-Net fc normalises over the 4 clouds) and 1.9e-7
    x = np.random.RandomState(30).uniform(-1, 1, (4, 64, 3)).astype(np.float32)
    for name, tol in (("pointnetvlad", 5e-5), ("epcnet", FP32_TOL)):
        jc, tc = _cfgs(name, compute_dtype="float32", num_points=64)
        flat = init_flat_variables(tc, seed=8)
        want = jax.jit(lambda v, p: j_get_model(jc).apply(
            v, p, train=True, momentum=0.6, mutable=["batch_stats"])[0])(_unflatten(flat),
                                                                        jnp.asarray(x))
        tm = get_model(tc, device="cpu")
        load_flat_variables(tm, flat)
        with torch.no_grad():
            got = tm(torch.tensor(x), train=True, momentum=0.6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_tnet", [True, False])
def test_pointnetvlad_matches_jax(use_tnet, dtype):
    """At a small width (pointnet_channels 16-64, 8 clusters, N=128), with
    seeded BN statistics and T-Net transforms."""
    x = np.random.RandomState(28).uniform(-1, 1, (2, 128, 3)).astype(np.float32)
    got, want = _both("pointnetvlad", 6, x, use_tnet=use_tnet, compute_dtype=dtype)
    assert got.shape == (2, 256) and np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("dim,dtype", [(3, "float32"), (3, "bfloat16"), (16, "bfloat16")])
def test_tnet_matches_jax(dim, dtype):
    """The transform alone, [B, dim, dim] fp32, from a seeded transform_w
    and BN statistics; transform_w keeps flax's layout (no transpose)."""
    rng = np.random.RandomState(29)
    x = rng.uniform(-1, 1, (2, 64, dim)).astype(np.float32)
    jd = jnp.dtype(dtype)
    jt = JTNet(dim, dtype=jd)
    v = jt.init(jax.random.PRNGKey(3), jnp.asarray(x).astype(jd), False, 0.9)
    v = {"params": _seeded_transforms(v["params"], rng),
         "batch_stats": _seeded_stats(v["batch_stats"], rng)}
    want = np.asarray(jt.apply(v, jnp.asarray(x).astype(jd), False, 0.9))
    tt = TNet(dim, getattr(torch, dtype))
    load_flat_variables(tt, flatten_variables(v["params"], v["batch_stats"]))
    np.testing.assert_array_equal(tt.transform_w.detach().numpy(),
                                  np.asarray(v["params"]["transform_w"]))
    with torch.inference_mode():
        got = tt(torch.tensor(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and got.shape == (2, dim, dim)
    assert np.abs(want - np.eye(dim)).max() > 0.02  # the transform does work
    np.testing.assert_allclose(got.numpy(), want,
                               atol=FP32_TOL if dtype == "float32" else BF16_TOL, rtol=0)


def test_pointnetvlad_full_width_params():
    jm = j_get_model(jcfg.pointnetvlad_config())
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 3)),
                                       train=False))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(v["params"]))
    assert n_jax == PNV_PARAMS
    with torch.device("meta"):
        assert param_count(PointNetVLAD(tcfg.pointnetvlad_config())) == PNV_PARAMS


# The bf16 GEMM reduction check: JAX's descriptors of the default full-width
# ModelConfig (bf16) at B=2, N=4096, from init_flat_variables(seed=0) and the
# file's seeded clouds, computed on the CPU. tests/test_torch_cuda.py holds
# the card's descriptors to it within BF16_TOL. Regenerate deliberately:
#   PYTHONPATH=. python tests/test_torch_models.py regen-bf16
BF16_FULLWIDTH = os.path.join(os.path.dirname(__file__), "torch_bf16_fullwidth.npz")
# XLA's CPU sums may take another order on another CPU: the recomputation is
# held to a tenth of BF16_TOL
BF16_FULLWIDTH_REPRO_TOL = 2e-5


def _unflatten(flat):
    """flatten_variables' names -> the nested {"params", "batch_stats"} tree."""
    tree = {}
    for name, arr in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def bf16_fullwidth_jax(seed=0):
    x = np.random.default_rng(seed).uniform(-1, 1, (2, 4096, 3)).astype(np.float32)
    flat = init_flat_variables(tcfg.ModelConfig(), seed=0)
    jm = j_get_model(jcfg.ModelConfig())
    fwd = jax.jit(lambda v, pts: jm.apply(v, pts, train=False))
    return x, flat, np.asarray(fwd(_unflatten(flat), jnp.asarray(x)))


def test_bf16_fullwidth_file_is_jax():
    """The committed file is what JAX computes, and the port's CPU path
    (the plain twins) lies within BF16_TOL of it."""
    data = np.load(BF16_FULLWIDTH)
    x, flat, want = bf16_fullwidth_jax(int(data["seed"]))
    assert want.shape == data["descriptors"].shape == (2, 256)
    np.testing.assert_allclose(want, data["descriptors"], atol=BF16_FULLWIDTH_REPRO_TOL,
                               rtol=0)
    m = get_model(tcfg.ModelConfig(), device="cpu")
    load_flat_variables(m, flat)
    with torch.inference_mode():
        got = m(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, data["descriptors"], atol=BF16_TOL, rtol=0)


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["regen-bf16"]:
        jax.config.update("jax_platforms", "cpu")
        np.savez(BF16_FULLWIDTH, descriptors=bf16_fullwidth_jax(0)[2], seed=np.int64(0))
        print(f"wrote {BF16_FULLWIDTH}")
