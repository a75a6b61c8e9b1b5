"""DGCNN-VLAD (``epcnet_torch/models/dgcnn.py``) and K8's plain version
(``ops/knn.py::knn_features_plain``) against plain references on the CPU.

The reference is ``tests/plain_dgcnn_vlad.py`` (torch only, fp32), on the
port's seeded weights (``init_flat_variables``) at the published widths
(EdgeConv 64, 64, 128, 256; conv5 1024; NetVLAD 64 x 1024 -> 256; k = 20),
B=2 submaps of N=256 points, in eval. Tolerances, from the worst of seeds
0-7 (the held seed is 0):

- fp32 (the algorithm): every layer's graph equal; descriptors 1.7e-7 ->
  1e-6 (BN's rsqrt against the reference's division, and sums in another
  order).
- bf16 (the configuration's precision; in eval the EdgeConvs take the
  per-point products and ``edge_max``) on the reference's own graphs:
  layer 0's graph equal (xyz stays fp32); on layers 1-3 bf16's rounding of
  the features swaps neighbours at near-ties (5-8%, 16-20% and 38-46% of
  the points in layers 1, 2, 3 hold a swapped neighbour, seeds 0-3), and the
  descriptors differ by up to 1.3e-2 -> 2e-2 (the edges, rounded to bf16
  before and after the Dense: 1.4e-2). A model that keeps layer 0's
  graph in every layer (the graph not built again) reads 2.8e-2 to 4.2e-2
  on the same seeds, so the limit tells the two apart.
- bf16 with the reference fed the port's graphs: the rounding alone, 2.0e-3
  -> 4e-3 (the edges: 2.3e-3; EPC-Net's bf16 gap at this size is of that
  order).

One training step (Adam) against the reference's autograd on the same
batch, 1 tuple of 1 query, 1 positive, 2 negatives and the other negative
at N=128, both sides in fp64 (the port's ``compute_dtype="float64"`` with
``model.double()``): the loss, every gradient (relative to the largest of
the tensor's) and the BN running statistics after the update. In fp32 a
max over k whose two largest edges lie within a rounding of each other
(4e-8 apart in one layer-3 max of seed 1) ties on one side and not on the
other, and ``amax`` splits a tied gradient where ``max`` does not: every
gradient of the backbone then moves by up to 6e-2 of its largest, which
says nothing of the step's algebra; fp64 leaves no such tie. The reference
takes the step's own graphs (a train forward of the port on the weights
before it; the graphs carry no gradient). Worst over seeds 0-7: loss
1.1e-16 -> 1e-12, gradient 3.4e-14 -> 1e-12, statistics 1.3e-15 ->
1e-13.
"""

import numpy as np
import pytest
import torch

import plain_dgcnn_vlad as plain
from epcnet_torch import losses
from epcnet_torch.configs import TrainConfig, dgcnn_vlad_config
from epcnet_torch.models import DGCNNVLAD, dgcnn, get_model, param_count
from epcnet_torch.ops.edge_max import edge_max_plain
from epcnet_torch.ops.knn import knn_features, knn_features_plain
from epcnet_torch.train.state import bn_momentum_schedule, create_train_state
from epcnet_torch.train.step import build_embed_fn, build_train_step
from epcnet_torch.utils.profiling import region_ms
from epcnet_torch.weights import flat_variables, init_flat_variables, load_flat_variables

N, B, K = 256, 2, 20
PARAMS = 17_592_256  # 618,176 in the backbone and conv5, 16,974,080 in NetVLAD
FP32_TOL = 1e-6
BF16_TOL = 2e-2
BF16_SAME_GRAPHS_TOL = 4e-3
STEP_TOL = dict(loss=1e-12, grad=1e-12, stats=1e-13)


@pytest.fixture(scope="module", autouse=True)
def four_torch_threads():
    """A fixed thread count, so each result is the same on every run."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def _model(seed, dtype="bfloat16", n=N):
    cfg = dgcnn_vlad_config(num_points=n, compute_dtype=dtype)
    model = get_model(cfg, "cpu")
    load_flat_variables(model, init_flat_variables(cfg, seed))
    weights = {k: v.detach().float().clone() for k, v in model.state_dict().items()}
    return cfg, model, weights


def _clouds(seed, b=B, n=N):
    return torch.tensor(np.random.default_rng(50 + seed).uniform(-1, 1, (b, n, 3)),
                        dtype=torch.float32)


def _gap(a, b):
    return float((a.float() - b.float()).norm(dim=1).max())


def test_published_widths():
    cfg = dgcnn_vlad_config()
    assert (cfg.num_points, cfg.knn_k, cfg.proxyconv_channels, cfg.lift_channels,
            cfg.feature_dim, cfg.vlad_clusters, cfg.vlad_groups, cfg.vlad_group_dim,
            cfg.output_dim, cfg.adjacency_format) == (4096, 20, (64, 64, 128, 256), (1024,),
                                                      1024, 64, 1, 256, 256, "gather")
    model = get_model(cfg, "cpu")
    assert isinstance(model, DGCNNVLAD) and param_count(model) == PARAMS
    assert model.netvlad.skip_out_fc
    assert dgcnn.BN_EPSILON == 1e-5 and dgcnn.LEAKY_SLOPE == 0.2
    assert all(m.epsilon == 1e-5 for m in model.modules() if hasattr(m, "epsilon"))
    for fmt in ("dense", "packed"):
        with pytest.raises(ValueError, match="adjacency_format"):
            get_model(cfg.variant(adjacency_format=fmt), "cpu")


def test_flat_variables_follow_the_module():
    cfg = dgcnn_vlad_config()
    flat = init_flat_variables(cfg, seed=3)
    model = get_model(cfg, "cpu")
    want = {}
    for key, t in model.named_parameters():
        path = key.split(".")
        shape = tuple(t.shape)
        if path[-1] == "weight":
            path[-1], shape = "kernel", shape[::-1]
        want["params/" + "/".join(path)] = shape
    for key, t in model.named_buffers():
        want["batch_stats/" + key.replace(".", "/")] = tuple(t.shape)
    assert {k: v.shape for k, v in flat.items()} == want
    assert not any(k.endswith("dense/bias") or k.endswith("dense_0/bias") for k in flat)
    assert flat["params/edgeconv_3/dense/kernel"].shape == (256, 256)
    assert flat["params/netvlad/group_w"].shape == (1, 65536, 256)
    load_flat_variables(model, flat)
    assert {k: v.tolist() for k, v in flat_variables(model).items()} == \
        {k: v.tolist() for k, v in flat.items()}


@pytest.mark.parametrize("seed", [0, 5])
def test_fp32_matches_plain(seed):
    cfg, model, w = _model(seed, "float32")
    x = _clouds(seed)
    with torch.no_grad():
        got, graphs = model.forward_with_graphs(x)
        want, want_graphs = plain.forward(w, x, K, cfg.proxyconv_channels)
    for g, h in zip(graphs, want_graphs):
        assert g.dtype == torch.int32 and torch.equal(g.long(), h)
    assert _gap(got, want) <= FP32_TOL


@pytest.mark.parametrize("seed", [0, 5])
def test_bf16_matches_plain(seed):
    cfg, model, w = _model(seed)
    x = _clouds(seed)
    with torch.no_grad():
        got, graphs = model.forward_with_graphs(x)
        want, want_graphs = plain.forward(w, x, K, cfg.proxyconv_channels)
        same, _ = plain.forward(w, x, K, cfg.proxyconv_channels, graphs_in=graphs)
    assert torch.equal(graphs[0].long(), want_graphs[0])
    assert _gap(got, want) <= BF16_TOL
    assert _gap(got, same) <= BF16_SAME_GRAPHS_TOL


def test_graph_is_built_again_at_every_layer(monkeypatch):
    """Layers 1.. take K8's path on the features the model holds (bf16)."""
    cfg, model, _ = _model(1)
    seen = []

    def spy(f, k):
        seen.append((f.dtype, tuple(f.shape), k))
        return knn_features(f, k)

    monkeypatch.setattr(dgcnn, "knn_features", spy)
    with torch.no_grad():
        model(_clouds(1))
    assert seen == [(torch.bfloat16, (B, N, c), K) for c in cfg.proxyconv_channels[:-1]]


def test_embed_fn_and_config_round_trip():
    """The normal path: a config read back from JSON, ``build_embed_fn``."""
    from epcnet_torch.configs import ExperimentConfig

    cfg = ExperimentConfig(model=dgcnn_vlad_config(num_points=64))
    back = ExperimentConfig.from_json(cfg.to_json()).model
    assert back == cfg.model
    embed = build_embed_fn(back, device="cpu")
    out = embed(np.asarray(_clouds(2, n=64)))
    assert out.shape == (B, 256)
    np.testing.assert_allclose(out.norm(dim=1).numpy(), 1.0, atol=1e-5)


def _batch(seed, n=128):
    rng = np.random.default_rng(300 + seed)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    return {"query": u(1, n, 3), "positives": u(1, 1, n, 3), "negatives": u(1, 2, n, 3),
            "other_neg": u(1, n, 3)}


@pytest.mark.parametrize("seed", [0, 1])
def test_train_step_matches_plain_autograd(seed):
    cfg = dgcnn_vlad_config(num_points=128, compute_dtype="float64")
    tc = TrainConfig(batch_num_queries=1)
    flat = init_flat_variables(cfg, seed)
    m = bn_momentum_schedule(tc)(0)
    batch = _batch(seed)
    clouds = torch.cat([torch.tensor(batch["query"])[:, None],
                        torch.tensor(batch["positives"]), torch.tensor(batch["negatives"]),
                        torch.tensor(batch["other_neg"])[:, None]], dim=1).reshape(-1, 128, 3)
    # the step's graphs, from the same forward on the weights before it
    graph_model = load_flat_variables(get_model(cfg, "cpu"), flat).double()
    with torch.no_grad():
        _, graphs = graph_model.forward_with_graphs(clouds, train=True, momentum=m)
    state = create_train_state(cfg, tc, "cpu", variables=flat)
    state.model.double()
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    state, metrics = build_train_step(cfg, tc)(state, batch)

    params = dict(state.model.named_parameters())
    w = {k: v.clone().requires_grad_(k in params) for k, v in before.items()}
    stats = {}
    desc, _ = plain.forward(w, clouds.double(), K, cfg.proxyconv_channels, train=True,
                            stats=stats, graphs_in=graphs)
    d = desc.reshape(1, 5, -1)
    loss = losses.get_loss(tc.loss)(d[:, 0], d[:, 1:2], d[:, 2:4], d[:, 4], tc.margin_1,
                                    tc.margin_2)
    loss.backward()
    assert abs(float(metrics["loss"]) - loss.item()) <= STEP_TOL["loss"]
    for key, p in params.items():
        assert p.grad.dtype == torch.float64
        want = w[key].grad
        scale = float(want.abs().max())
        assert float((p.grad - want).abs().max()) <= STEP_TOL["grad"] * scale, key
    buffers = dict(state.model.named_buffers())
    for key, (mean, var) in stats.items():
        for leaf, batch_value in (("mean", mean), ("var", var)):
            want = m * before[f"{key}.{leaf}"] + (1 - m) * batch_value
            got = buffers[f"{key}.{leaf}"]
            assert float((got - want).abs().max()) <= STEP_TOL["stats"], (key, leaf)


def _exact_scores(f):
    """fp64 scores ||f_j||^2 - 2 <f_i, f_j> of features f [B, N, D]."""
    x = f.double()
    return (x * x).sum(-1)[:, None, :] - 2 * x @ x.transpose(1, 2)


@pytest.mark.parametrize("d,k,grid", [(64, 20, 4), (128, 20, 2), (16, 32, 1), (256, 7, 4)])
def test_knn_features_plain_matches_fp64_sort(d, k, grid):
    """On features on a coarse grid every product and sum is exact in fp32,
    so the order is the fp64 stable sort's exactly, ties (many, and
    duplicate points) to the lower index, self included."""
    rng = np.random.default_rng(d + k)
    f = torch.tensor(np.round(rng.uniform(-1, 1, (2, 300, d)) * grid) / grid,
                     dtype=torch.bfloat16)
    f[:, 7] = f[:, 3]  # a duplicate point
    got = knn_features_plain(f, k)
    want = torch.sort(_exact_scores(f), dim=-1, stable=True).indices[..., :k]
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)
    rows = torch.arange(300)
    # self is in every list, first unless a lower index ties with it
    assert bool((got.long() == rows[None, :, None]).any(-1).all())
    assert torch.equal(got[:, 7, 0].long(), torch.tensor([3, 3]))


def test_knn_features_plain_random_bf16():
    """Random bf16 features: the fp32 scores order as fp64's except at
    near-ties, within fp32's rounding of the sums (2^-22 of the terms'
    magnitudes, far below the gap of any pair it swaps)."""
    f = torch.randn(2, 500, 64, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    got = knn_features_plain(f, 20)
    s = _exact_scores(f)
    want = torch.sort(s, dim=-1, stable=True).indices[..., :20]
    kth = s.gather(-1, want[..., -1:])
    scale = (f.double() ** 2).sum(-1).amax() * 4
    for g, w_, row, t in zip(got.reshape(-1, 20), want.reshape(-1, 20), s.reshape(-1, 500),
                             kth.reshape(-1)):
        diff = set(g.tolist()) ^ set(w_.tolist())
        assert all(abs(float(row[j] - t)) <= 2 ** -20 * float(scale) for j in diff)


def test_knn_features_rejects_bad_input():
    f = torch.zeros(1, 10, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k="):
        knn_features(f, 11)
    with pytest.raises(ValueError, match="CUDA"):
        from epcnet_torch.ops.knn import knn_features_cuda

        knn_features_cuda(f, 4)


def test_spans_name_each_layer():
    """The spans the benchmark's per-layer readers read: each layer's graph
    and EdgeConv, conv5 and the head, once a forward."""
    _, model, _ = _model(0, n=64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(_clouds(0, n=64))
    regions = region_ms(prof, "dgcnn/")
    want = {f"dgcnn/{part}_{i}" for part in ("knn", "edgeconv") for i in range(4)}
    assert set(regions) == want | {"dgcnn/lift", "dgcnn/vlad"}
    assert all(r["count"] == 1 for r in regions.values())



def _edgeconv(c_in, cout, seed, dtype=torch.float64):
    """An EdgeConv with seeded weights and BN: statistics away from their
    start, scales of both signs and one zero."""
    gen = torch.Generator().manual_seed(seed)
    layer = dgcnn.EdgeConv(c_in, cout, dtype)
    with torch.no_grad():
        layer.dense.weight.copy_(torch.randn(cout, 2 * c_in, generator=gen) / (2 * c_in) ** 0.5)
        bn = layer.bn
        bn.mean.copy_(torch.randn(cout, generator=gen) * 0.5)
        bn.var.copy_(torch.rand(cout, generator=gen) * 2 + 0.05)
        bn.scale.copy_(torch.randn(cout, generator=gen) * 0.4 + 1)
        bn.scale[1::3] *= -1
        bn.scale[0] = 0
        bn.bias.copy_(torch.randn(cout, generator=gen) * 0.3)
    return layer


def _ids(seed, b, n, k):
    """int32 id lists [b, n, k] with repeats, each holding the point itself."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, n, (b, n, k), generator=gen)
    ids[..., 0] = torch.arange(n)
    ids[..., 1] = ids[..., 2]  # a repeat in every list
    return ids.to(torch.int32)


@pytest.mark.parametrize("c_in,cout", [(3, 64), (64, 128), (128, 256)])
def test_eval_algebra_is_the_published_edgeconv(c_in, cout):
    """``edge_max_plain`` fed ``x @ [W1; W2]ᵀ`` against the published
    EdgeConv (gather, concat, Dense, BN, LeakyReLU, amax; the module in fp64
    takes it), both in fp64: equal within 1e-12."""
    layer = _edgeconv(c_in, cout, c_in + cout).double()
    assert bool((layer.bn.scale < 0).any() and (layer.bn.scale == 0).any())
    gen = torch.Generator().manual_seed(cout)
    x = torch.randn(2, 96, c_in, generator=gen, dtype=torch.float64)
    ids = _ids(c_in, 2, 96, K)
    with torch.no_grad():
        want = layer(x, ids)
        w = layer.dense.weight
        y = x @ torch.cat([w[:, :c_in], w[:, c_in:]]).t()
        bn = layer.bn
        got = edge_max_plain(y, ids, bn.mean, bn.var, bn.scale, bn.bias, bn.epsilon,
                             dtype=torch.float64)
    assert got.dtype == want.dtype == torch.float64 and got.shape == (2, 96, cout)
    assert float((got - want).abs().max()) <= 1e-12


@pytest.mark.parametrize("case", ["eval", "train", "grad", "float32", "float64"])
def test_eval_path_only_where_no_graph_is_built(case, monkeypatch):
    """A bf16 EdgeConv in eval without grad takes the product over the
    points and ``edge_max`` (no gathered features); training, grad-enabled
    calls, fp32 and fp64 keep the published edges. The eval path is within
    two bf16 roundings of the published function in fp64 on the same inputs
    (the weights rounded to bf16, as the bf16 Dense takes them)."""
    dtype = {"float32": torch.float32, "float64": torch.float64}.get(case, torch.bfloat16)
    layer = _edgeconv(16, 64, 2, dtype)
    if case == "float64":
        layer.double()
    calls = {"gather": 0, "edge_max": 0}

    def spy(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(dgcnn, "gather_neighbors" if name == "gather" else name, counted)

    spy("gather", dgcnn.gather_neighbors)
    spy("edge_max", dgcnn.edge_max)
    x = torch.randn(2, 80, 16, generator=torch.Generator().manual_seed(3)).to(dtype)
    ids = _ids(4, 2, 80, K)
    with torch.set_grad_enabled(case in ("train", "grad")):
        got = layer(x, ids, train=case == "train")
    assert got.shape == (2, 80, 64) and got.dtype == dtype
    assert calls == ({"gather": 0, "edge_max": 1} if case == "eval" else
                     {"gather": 1, "edge_max": 0})
    assert (layer.bn.pending is not None) == (case == "train")
    if case == "eval":
        exact = _edgeconv(16, 64, 2).double()
        with torch.no_grad():
            exact.dense.weight.copy_(layer.dense.weight.to(dtype))
            want = exact(x.double(), ids)
        # two bf16 roundings (the BN output, then the LeakyReLU's product)
        assert bool(((got.double() - want).abs() <= 2 ** -7 * want.abs() + 1e-5).all())
