"""DGCNN-VLAD's reference, weights and counts, and the two cells of the
``embed_by_model`` traffic kind, on the CPU at a tiny size: the reference
against the port in fp32 (the same mathematics: equal to fp32 rounding), in
bf16 within its gap with the control well outside it, the weights' leaves
against the port's module, the counts by hand, and a run of each cell
correct, with an altered descriptor not."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench_h100 import counts_graph, data, harness
from bench_h100.program import model_config, place_index
from bench_h100.reference import dgcnn_vlad as ref
from bench_h100.reference.precision import CONTROL
from bench_h100.tests.test_bench_h100_faults import SEED, _altered_embed
from bench_h100.weights_dgcnn_vlad import leaves, make_weights

MODEL = harness.load_json(harness.HERE, "configs", "dgcnn_vlad.json")["model"]


def tiny(**kw):
    return {**MODEL, "num_points": 256, **kw}


def test_leaves_are_the_ports():
    from epcnet_torch.models import get_model

    port = get_model(model_config(MODEL), "cpu")
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: shape for k, shape, _ in leaves(MODEL)} == want
    assert sum(int(np.prod(s)) for k, s, _ in leaves(MODEL)
               if not k.endswith((".mean", ".var"))) == 17_592_256


def test_forward_matches_the_port_in_fp32():
    model = tiny(compute_dtype="float32")
    w = make_weights(model, 5, "cpu")
    pts = data.blob_submaps(np.random.default_rng(1), 3, 256)
    got = torch.as_tensor(place_index(model, w, "cpu", batch=4, max_k=1).embed(pts))
    want = ref.embed(w, model, pts, "cpu")
    assert (got - want).norm(dim=1).max() < 1e-5
    assert torch.allclose(want.norm(dim=1), torch.ones(3), atol=1e-5)


def test_forward_bf16_gap_and_control():
    """bf16, as configured: within 1e-2 (3.4e-3 to 5.5e-3 on seeds 0-2 at
    this size); the control (fp8 backbone, TF32 head) reads more than 3x
    the port's gap (1.9e-2 to 3.0e-2)."""
    model = tiny()
    w = make_weights(model, 0, "cpu")
    pts = data.blob_submaps(np.random.default_rng(0), 4, 256)
    got = torch.as_tensor(place_index(model, w, "cpu", batch=4, max_k=1).embed(pts))
    want = ref.embed(w, model, pts, "cpu")
    ctl = ref.embed(w, model, pts, "cpu", p=CONTROL)
    gap, ctl_gap = (got - want).norm(dim=1).max(), (ctl - want).norm(dim=1).max()
    assert gap < 1e-2 and ctl_gap > 3 * gap


def test_graphs_built_again_at_each_layer(monkeypatch):
    monkeypatch.setattr(ref, "ROWS", 100)  # blocks that split the rows
    model = tiny()
    w = make_weights(model, 2, "cpu")
    x = torch.as_tensor(data.blob_submaps(np.random.default_rng(3), 2, 256))
    _, graphs = ref.forward_with_graphs(w, model, x)
    assert [g.shape for g in graphs] == [(2, 256, 20)] * 4
    assert not torch.equal(graphs[0], graphs[1])
    rows = torch.arange(256)
    for g in graphs:  # the point itself is its own nearest
        assert torch.equal(g[..., 0], rows.expand(2, -1))


def test_counts_by_hand():
    """Per submap at N=4096: edges 14.83 GFLOP, the feature kNN's inner
    products 8.59, conv5 4.29, the assignment 0.54 (bf16); layer 0's kNN,
    layers 1-3's subtraction and norms, the VLAD sums, the FC and the gate
    (fp32)."""
    n, k = 4096, 20
    edges = 2 * n * k * (6 * 64 + 128 * 64 + 128 * 128 + 256 * 256)
    dots = 2 * n * n * (64 + 64 + 128)
    f = counts_graph.dgcnn_forward_flops(MODEL, n)
    assert f["bf16_flops"] == edges + dots + 2 * n * 512 * 1024 + 2 * n * 1024 * 64
    assert edges == 14_826_864_640 and dots == 8_589_934_592
    assert f["fp32_flops"] == (8 * n * n + 3 * n * n + 2 * n * (64 + 64 + 128)
                               + 2 * 64 * n * 1024 + 2 * 64 * 1024 * 256 + 2 * 256 * 256)
    w8 = counts_graph.k8_work(32, n, 64, k)
    assert w8["bf16_flops"] == 2 * 64 * 32 * n * n and w8["bytes"] == 32 * n * (128 + 80)
    assert counts_graph.k2_work(1, 65536, k)["fp32_flops"] == 8 * 65536 ** 2


SIZES = {
    "dgcnn_vlad.embed.map_b32": ({"batch": 4, "pool": 8}, {}),
    # the gather route at a size the CPU runs: asked for, as "auto" takes it
    # past N=32768 only
    "epcnet.embed.gather_n65536": ({"batch": 1, "pool": 4, "num_points": 256},
                                   {"adjacency_format": "gather"}),
}


def _run(name, broken=None):
    cell = harness.Cell(name)
    params, model_kw = SIZES[name]
    model = {**cell.config["model"], "num_points": 256, **model_kw}
    kind = cell.kind("cpu", SEED, model=model, params=params)
    if broken is not None:
        setup = kind.setup

        def broken_setup():
            setup()
            broken(kind)

        kind.setup = broken_setup
    return harness.run_cell(cell, SEED, 0.3, False, "cpu", time.perf_counter(), kind=kind)


@pytest.mark.parametrize("name", list(SIZES))
def test_cells_correct_and_altered_not(name):
    out = _run(name)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["metrics"]["embed_submaps_per_s"]["value"] > 0
    bad = _run(name, _altered_embed)
    assert not bad["correct"], bad["check"]


def test_num_points_param_sets_the_model():
    cell = harness.Cell("epcnet.embed.gather_n65536")
    kind = cell.kind("cpu", SEED)
    assert kind.model["num_points"] == 65536 and cell.config["model"]["num_points"] == 4096
    with pytest.raises(KeyError, match="no reference"):
        cell.kind("cpu", SEED, model={**cell.config["model"], "name": "pointnetvlad"})


def test_any_n_reference_is_the_reference(monkeypatch):
    """``model_any_n`` gives ``model.py``'s ids and descriptors."""
    from bench_h100.reference import model as ref_model
    from bench_h100.reference import model_any_n
    from bench_h100.weights import make_weights as epcnet_weights

    monkeypatch.setattr(ref_model, "ROWS", 100)  # blocks that split the rows
    m = {**harness.load_json(harness.HERE, "configs", "epcnet.json")["model"],
         "num_points": 256}
    x = torch.as_tensor(data.blob_submaps(np.random.default_rng(4), 2, 256))
    x[:, 7] = x[:, 3]  # a tie: equal points order by index
    assert torch.equal(model_any_n.knn_ids(x, 20), ref_model.knn_ids(x, 20))
    w = epcnet_weights(m, 3, "cpu")
    assert torch.equal(model_any_n.embed(w, m, x, "cpu"), ref_model.embed(w, m, x, "cpu"))
