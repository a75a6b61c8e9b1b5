"""The seeded inputs: the open-loop schedule, sub-seeds and weights."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_h100 import data, harness, weights

SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_open_loop_schedule(seed):
    due, which = data.open_loop_schedule(seed, 1500.0, 10.0, 256)
    assert len(due) == len(which) == 15000
    assert np.all(np.diff(due) > 0) and due[0] > 0
    # the last request is due just before the window closes
    assert due[-1] == pytest.approx(10.0 * (15000 - 0.5) / 15000)
    # every submap is asked for equally often (to one)
    counts = np.bincount(which, minlength=256)
    assert counts.max() - counts.min() <= 1
    # gaps of Poisson arrivals: mean 1/rate, coefficient of variation ~1
    gaps = np.diff(np.concatenate([[0.0], due]))
    assert gaps.mean() == pytest.approx(1 / 1500, rel=1e-3)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.05)


def test_schedule_same_work_other_order():
    """Two seeds get the same set of gaps and submaps, in another order."""
    d1, w1 = data.open_loop_schedule(1, 800.0, 5.0, 64)
    d2, w2 = data.open_loop_schedule(2, 800.0, 5.0, 64)
    g1, g2 = np.diff(np.concatenate([[0], d1])), np.diff(np.concatenate([[0], d2]))
    assert np.allclose(np.sort(g1), np.sort(g2)) and not np.allclose(g1, g2)
    assert np.array_equal(np.sort(w1), np.sort(w2)) and not np.array_equal(w1, w2)
    d3, w3 = data.open_loop_schedule(1, 800.0, 5.0, 64)
    assert np.array_equal(d1, d3) and np.array_equal(w1, w3)


def test_sub_seeds_differ_by_purpose_and_seed():
    a = data.rng(2 ** 33 + 5, "pool").integers(1 << 30, size=4)
    b = data.rng(2 ** 33 + 5, "db").integers(1 << 30, size=4)
    c = data.rng(5, "pool").integers(1 << 30, size=4)
    assert not np.array_equal(a, b) and not np.array_equal(a, c)
    assert 0 <= data.torch_seed(2 ** 63 + 1, "weights") < 2 ** 63


@pytest.mark.parametrize("name", ["epcnet", "epcnet_l"])
def test_weights_cover_the_port_model(name):
    """The seeded weights name every leaf of the port's model, with its
    shape, and the same seed gives the same weights."""
    from bench_h100.program import model_config
    from epcnet_torch.models import model_class

    model = harness.load_json(harness.HERE, "configs", name + ".json")["model"]
    w = weights.make_weights(model, 123, "cpu")
    cfg = model_config(model)
    with torch.device("meta"):
        port = model_class(cfg)(cfg)
    want = {k: tuple(v.shape) for k, v in list(port.named_parameters())
            + list(port.named_buffers())}
    assert {k: tuple(v.shape) for k, v in w.items()} == want
    again = weights.make_weights(model, 123, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert (w["lift.bn_1.var"] >= 0.5).all() and (w["lift.bn_1.var"] <= 1.5).all()
    flat = weights.to_flat(w)
    assert flat["params/lift/dense_1/kernel"].shape == (model["lift_channels"][0],
                                                         model["lift_channels"][1])
    assert "batch_stats/lift/bn_1/var" in flat


def test_blob_submaps_copy():
    """The copy of the program's generator gives its submaps bit for bit."""
    from epcnet_torch.scripts.train_bench import blob_submaps

    a = data.blob_submaps(np.random.default_rng(3), 4, 512)
    b = blob_submaps(np.random.default_rng(3), 4, 512)
    assert np.array_equal(a, b) and a.dtype == np.float32
