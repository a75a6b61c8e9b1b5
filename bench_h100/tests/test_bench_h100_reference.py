"""The plain reference against the port's plain path at a tiny size, on the
CPU: the port run in fp32 (``compute_dtype="float32"``) computes the same
mathematics, so the two agree to fp32 rounding; in bf16, as configured, the
port stays within the bf16 gap that the cells' limits allow for."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_h100 import data, harness
from bench_h100.program import PortTrainer, place_index
from bench_h100.reference import model as ref_model
from bench_h100.reference import retrieval as ref_retrieval
from bench_h100.reference.train import Trainer
from bench_h100.weights import make_weights

CONFIGS = {n: harness.load_json(harness.HERE, "configs", n + ".json")
           for n in ("epcnet", "epcnet_l")}


def tiny(name, **kw):
    return {**CONFIGS[name]["model"], "num_points": 256, **kw}


@pytest.mark.parametrize("name", ["epcnet", "epcnet_l"])
def test_knn_ids_match_the_port(name, monkeypatch):
    from epcnet_torch.ops.knn import knn_plain

    monkeypatch.setattr(ref_model, "ROWS", 100)  # blocks that split the rows
    x = torch.as_tensor(data.blob_submaps(np.random.default_rng(0), 2, 256))
    x[:, 7] = x[:, 3]  # a tie: equal points order by index
    ours = ref_model.knn_ids(x, 20)
    assert torch.equal(ours, knn_plain(x, 20).long())


@pytest.mark.parametrize("name", ["epcnet", "epcnet_l"])
def test_forward_matches_the_port_in_fp32(name):
    model = tiny(name, compute_dtype="float32")
    w = make_weights(model, 5, "cpu")
    pts = data.blob_submaps(np.random.default_rng(1), 3, 256)
    index = place_index(model, w, "cpu", batch=4, max_k=1)
    got = torch.as_tensor(index.embed(pts))
    ref = ref_model.embed(w, model, pts, "cpu")
    assert (got - ref).norm(dim=1).max() < 1e-4
    assert torch.allclose(ref.norm(dim=1), torch.ones(3), atol=1e-5)


def test_forward_bf16_gap():
    """As configured (bf16 backbone) the port stays within 1e-2 of the
    reference at this size; the control's rounding does not."""
    model = tiny("epcnet")
    w = make_weights(model, 6, "cpu")
    pts = data.blob_submaps(np.random.default_rng(2), 4, 256)
    got = torch.as_tensor(place_index(model, w, "cpu", batch=4, max_k=1).embed(pts))
    ref = ref_model.embed(w, model, pts, "cpu")
    ctl = torch.as_tensor(place_index(model, w, "cpu", batch=4, max_k=1,
                                      control=True).embed(pts))
    gap, ctl_gap = (got - ref).norm(dim=1).max(), (ctl - ref).norm(dim=1).max()
    assert gap < 1e-2 and ctl_gap > 3 * gap


def _train_readings(trainer, batches, w, b1):
    trainer.step(batches[0])
    grad = {k: float(v.norm() / (1 - b1)) for k, v in trainer.first_moments().items()}
    for b in batches[1:3]:
        trainer.step(b)
    leaves = trainer.leaves()
    return ([float(x) for x in trainer.losses[:3]], grad,
            {k: float((v - w[k]).norm()) for k, v in leaves.items()})


def test_train_step_matches_the_port_in_fp32():
    model = tiny("epcnet", compute_dtype="float32")
    train = CONFIGS["epcnet"]["train"]
    w = make_weights(model, 8, "cpu")
    r = np.random.default_rng(9)
    batches = [data.tuple_batch(r, 2, 1, 2, 256) for _ in range(3)]
    b1 = train["adam_b1"]
    lp, gp, cp = _train_readings(PortTrainer(model, train, w, "cpu", 2), batches, w, b1)
    lr, gr, cr = _train_readings(Trainer(w, model, train, "cpu"), batches, w, b1)
    assert np.allclose(lp, lr, rtol=1e-5)
    med = np.median(list(gr.values()))
    for k in gr:
        assert abs(gp[k] - gr[k]) <= 1e-3 * max(gr[k], med), k
    medc = np.median(list(cr.values()))
    for k in cr:
        if k in gr and gr[k] < 1e-3 * med:
            continue  # a bias BN cancels: Adam moves it by rounding alone
        assert abs(cp[k] - cr[k]) <= 1e-3 * max(cr[k], medc), k


def test_exact_topk(monkeypatch):
    monkeypatch.setattr(ref_retrieval, "BLOCK", 1024)  # blocks that split the rows
    r = np.random.default_rng(4)
    db = r.standard_normal((5000, 16)).astype(np.float32)
    db[10] = db[20]  # a tie: the lower row first
    q = np.stack([db[20], db[3]])
    ids, dist = ref_retrieval.topk(q, db, 5, "cpu")
    d = ((db[None].astype(np.float64) - q[:, None]) ** 2).sum(-1)
    want = np.lexsort((np.broadcast_to(np.arange(5000), d.shape), d), axis=1)[:, :5]
    assert np.array_equal(ids, want) and ids[0, 0] == 10 and ids[0, 1] == 20
    assert np.allclose(dist, np.take_along_axis(d, want, 1))
