"""The operation and byte counts against hand counts, for both
configurations."""

from __future__ import annotations

import pytest

from bench_h100 import counts, harness

MODELS = {n: harness.load_json(harness.HERE, "configs", n + ".json")["model"]
          for n in ("epcnet", "epcnet_l")}


def hand_forward(n, k, chans, lift, c, d, gd, out):
    """Written out layer by layer: ProxyConv i is a Dense of 2·C_in -> C_i on
    N rows (bf16) and N·k·C_in neighbour sums; the lift two Dense; the
    assignment D -> C (bf16); A^T X (fp32, 2·C·N·D); the grouped FC
    (C·D·gd·2 in all), the output FC and the gate (fp32); the kNN 8·N²."""
    bf16 = fp32 = 0
    fp32 += 8 * n * n
    prev = 3
    for ch in chans:
        bf16 += 2 * n * 2 * prev * ch
        fp32 += n * k * prev
        prev = ch
    prev = sum(chans)
    for w in lift:
        bf16 += 2 * n * prev * w
        prev = w
    bf16 += 2 * n * d * c
    fp32 += 2 * c * n * d + 2 * c * d * gd + 2 * 8 * gd * out + 2 * out * out
    return bf16, fp32


def test_epcnet_forward_by_hand():
    f = counts.forward_flops(MODELS["epcnet"], 4096)
    bf16, fp32 = hand_forward(4096, 20, (64, 64, 64, 128), (256, 1024), 64, 1024, 32, 256)
    assert (f["bf16_flops"], f["fp32_flops"]) == (bf16, fp32)
    # 3.63 GFLOP bf16 and 0.69 GFLOP fp32 a submap
    assert f["bf16_flops"] == 3_627_024_384 and f["fp32_flops"] == 691_519_488


def test_epcnet_l_forward_by_hand():
    f = counts.forward_flops(MODELS["epcnet_l"], 4096)
    bf16, fp32 = hand_forward(4096, 20, (16, 16, 16, 32), (64, 256), 64, 256, 32, 256)
    assert (f["bf16_flops"], f["fp32_flops"]) == (bf16, fp32)


@pytest.mark.parametrize("name,params", [("epcnet", 2_742_144), ("epcnet_l", 713_808)])
def test_param_count(name, params):
    """The parameter count, against the port's model built from the same
    configuration (2,742,144 for EPC-Net, as PERF.md states)."""
    from bench_h100.program import model_config
    from epcnet_torch.models import model_class

    import torch

    assert counts.param_count(MODELS[name]) == params
    cfg = model_config(MODELS[name])
    with torch.device("meta"):
        model = model_class(cfg)(cfg)
    assert sum(p.numel() for p in model.parameters()) == params


def test_k1_work():
    w = counts.k1_work(32, 4096)
    # xyz read once (fp32), the int8 indicator and the bf16 proxy written once
    assert w["bytes"] == 32 * 4096 * 12 + 32 * 4096 ** 2 + 32 * 4096 * 6
    assert w["fp32_flops"] == 8 * 32 * 4096 ** 2
    # bandwidth-bound: 0.161 ms at 3.35 TB/s
    assert counts.least_seconds(w) == pytest.approx(w["bytes"] / 3.35e12)
    assert counts.least_seconds(w) == pytest.approx(0.16096e-3, rel=1e-4)


def test_train_step_work():
    m = MODELS["epcnet"]
    f = counts.forward_flops(m, 4096)
    w = counts.train_step_work(m, 44, 4096)
    knn = 8 * 4096 ** 2
    assert w["bf16_flops"] == 3 * 44 * f["bf16_flops"]
    assert w["fp32_flops"] == 44 * (knn + 3 * (f["fp32_flops"] - knn)) + 12 * 2_742_144
    assert counts.least_seconds(w) == pytest.approx(
        w["bf16_flops"] / 989e12 + w["fp32_flops"] / 67e12)
