"""A run with the timed path broken underneath comes out not correct; the
same run unbroken comes out correct. Each cell's run is driven on the CPU at
a tiny size (the harness's look for a card skipped), with each fault the
cell can have: a step that leaves the state unchanged, half of the batch
left out (the mean taken over the rest), an answer altered where it is
produced. One card only: no exchange between chips to leave out."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench_h100 import harness

SEED = 2 ** 31 + 12345
SIZES = {
    "epcnet.embed.map_b32": ({"batch": 4, "pool": 8}, 0.3),
    "epcnet_l.embed.map_b32": ({"batch": 4, "pool": 8}, 0.3),
    # dispatches collect for 100 ms, so that each holds several requests
    "epcnet.serve.poisson_1e6": ({"rows": 3000, "pool": 12, "rate_per_s": 40.0,
                                  "embed_batch": 4, "max_wait_ms": 100.0,
                                  "drain_s": 60.0}, 0.6),
    "epcnet.train.tuples_b2": ({"tuples": 2, "positives": 1, "negatives": 2, "pool": 4}, 0.1),
}


def run(name, break_after_setup=None, control=False):
    cell = harness.Cell(name)
    params, seconds = SIZES[name]
    model = {**cell.config["model"], "num_points": 256}
    kind = cell.kind("cpu", SEED, control=control, model=model, params=params)
    if break_after_setup is not None:
        setup = kind.setup

        def broken_setup():
            setup()
            break_after_setup(kind)

        kind.setup = broken_setup
    return harness.run_cell(cell, SEED, seconds, False, "cpu", time.perf_counter(), kind=kind)


def _half_embed(kind):
    """The embed leaves the second half of each batch out (zeros)."""
    embed = kind.index._embed

    def half(points):
        out = torch.zeros((points.shape[0], kind.model["output_dim"]))
        out[:points.shape[0] // 2] = embed(points[:points.shape[0] // 2])
        return out

    kind.index._embed = half


def _altered_embed(kind):
    """The first descriptor of each batch comes out with two entries
    swapped."""
    embed = kind.index._embed

    def altered(points):
        out = embed(points).clone()
        out[0, [0, 1]] = out[0, [1, 0]]
        return out

    kind.index._embed = altered


def _altered_answer(kind):
    """Each dispatch's first answer comes out with its ranks 1 and 2
    swapped."""
    query = kind.index.query

    def altered(points, k=25):
        ids, dists = query(points, k)
        ids = ids.copy()
        ids[0, [1, 2]] = ids[0, [2, 1]]
        return ids, dists

    kind.index.query = altered


@pytest.mark.parametrize("name", list(SIZES))
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("name,fault", [
    ("epcnet.embed.map_b32", _half_embed), ("epcnet.embed.map_b32", _altered_embed),
    ("epcnet_l.embed.map_b32", _half_embed), ("epcnet_l.embed.map_b32", _altered_embed),
    ("epcnet.serve.poisson_1e6", _half_embed), ("epcnet.serve.poisson_1e6", _altered_answer),
])
def test_broken_run_is_not_correct(name, fault):
    out = run(name, break_after_setup=fault)
    assert not out["correct"], out["check"]


def test_train_state_unchanged_is_not_correct(monkeypatch):
    """Neither the optimiser's update nor BN's running update happens."""
    import epcnet_torch.train.step as step

    def no_update(state, lr, accum, group=None):
        state.step += 1

    monkeypatch.setattr(step, "_apply_update", no_update)
    monkeypatch.setattr(step, "commit_batch_stats", lambda model: 0)
    out = run("epcnet.train.tuples_b2")
    assert not out["correct"]
    for name in ("change_gap", "bn_gap"):
        assert out["check"][name]["value"] == pytest.approx(1.0)


def test_train_state_unchanged_in_the_window_is_not_correct(monkeypatch):
    """Set-up's first three steps update; the window's steps do not. Only
    the window's last step, held against the reference's step from the
    same state, can see it."""
    import epcnet_torch.train.step as step

    def no_update(state, lr, accum, group=None):
        state.step += 1

    def broken(kind):
        monkeypatch.setattr(step, "_apply_update", no_update)
        monkeypatch.setattr(step, "commit_batch_stats", lambda model: 0)

    out = run("epcnet.train.tuples_b2", break_after_setup=broken)
    assert not out["correct"]
    for name in ("change_gap", "bn_gap"):
        assert out["check"][name]["value"] <= out["check"][name]["limit"]
        assert out["check"]["last_" + name]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_not_correct(monkeypatch):
    import epcnet_torch.train.step as step

    to_device = step.to_device

    def half(batch, device):
        return to_device({k: np.asarray(v)[: len(v) // 2] for k, v in batch.items()}, device)

    monkeypatch.setattr(step, "to_device", half)
    out = run("epcnet.train.tuples_b2")
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("name", list(SIZES))
def test_control_is_not_correct(name):
    """The reference in the program's place, its bf16 products in fp8 and
    its fp32 ones in TF32 (``reference/precision.py``), fails the check."""
    out = run(name, control=True)
    assert not out["correct"], out["check"]
