"""The port's timing, profiling and debugging helpers (``epcnet_torch/utils``)
on the CPU: what they return on CPU tensors and a CPU profile, and which
paths the finiteness checks name. The device side (``cuda_ms``, a profile
with CUDA activity) runs on the card in ``chip_smoke.py``."""

import contextlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from epcnet_torch.configs import ModelConfig
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.utils.debugging import assert_all_finite, checked_step
from epcnet_torch.utils import (
    device_sync,
    profile_region,
    region_ms,
    start_trace,
    timeit,
    timeit_pipelined,
    top_device_ops,
)

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def test_timeit_returns_positive_seconds():
    x = torch.ones(256, 256)
    assert timeit(lambda: x @ x, iters=5, warmup=1) > 0
    assert timeit_pipelined(lambda: x @ x, iters=5, warmup=1) > 0


def test_device_sync_on_cpu_is_a_no_op(monkeypatch):
    def refuse(*_):
        raise AssertionError("synchronize called for CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    device_sync(torch.ones(3))
    device_sync({"a": [torch.ones(2), (torch.zeros(1), None)], "b": 3})
    device_sync(None)


def test_top_device_ops_ranks_a_cpu_profile(tmp_path):
    cfg = ModelConfig(num_points=64, knn_k=6, proxyconv_channels=(8, 8, 8, 16),
                      lift_channels=(32, 64), feature_dim=64, vlad_clusters=4,
                      vlad_groups=2, vlad_group_dim=8)
    embed = build_embed_fn(cfg, device="cpu")
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    embed(x)
    with start_trace(str(tmp_path)) as prof:
        for _ in range(2):
            embed(x)
    assert os.path.getsize(tmp_path / "trace.json") > 0
    ops = top_device_ops(prof, top=5)
    assert ops["ranked_by"] == "cpu" and len(ops["top"]) == 5
    times = [r["total_ms"] for r in ops["top"]]
    assert times == sorted(times, reverse=True) and times[0] > 0
    assert ops["total_ms"] >= sum(times)
    assert all(r["count"] >= 1 and isinstance(r["name"], str) for r in ops["top"])
    assert not any(r["name"].startswith("epcnet/") for r in ops["top"])  # spans excluded
    regions = region_ms(prof, "epcnet/")
    assert regions["epcnet/knn_graph"]["count"] == 2
    assert regions["epcnet/neighbor_mean"]["count"] == 6
    assert all(r["total_ms"] > 0 for r in regions.values())


def test_gather_route_means_are_a_span():
    """On the gather route each layer's mean (``gather_neighbor_mean``) is
    the span ``epcnet/neighbor_mean``, beside the kNN graph's, so that the
    benchmark's ``embed.adjacency_ms`` reads the route's graph work whole."""
    cfg = ModelConfig(num_points=64, knn_k=6, proxyconv_channels=(8, 8, 8, 16),
                      lift_channels=(32, 64), feature_dim=64, vlad_clusters=4,
                      vlad_groups=2, vlad_group_dim=8, adjacency_format="gather")
    embed = build_embed_fn(cfg, device="cpu")
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        embed(x)
    regions = region_ms(prof, "epcnet/")
    assert regions["epcnet/knn_graph"]["count"] == 1
    assert regions["epcnet/neighbor_mean"]["count"] == 4  # every layer, layer 0 included
    assert "epcnet/indicator_cast" not in regions


def test_start_trace_writes_a_chrome_trace_into_a_new_directory(tmp_path):
    out = tmp_path / "a" / "b"
    with start_trace(str(out)) as prof:
        torch.ones(4).sum()
    assert prof is not None
    with open(out / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_profile_region_is_a_named_span(tmp_path):
    with start_trace(str(tmp_path)) as prof:
        for _ in range(3):
            with profile_region("probe/sum"):
                torch.ones(1000).sum()
    assert region_ms(prof, "probe/")["probe/sum"]["count"] == 3
    assert region_ms(prof, "other/") == {}
    assert isinstance(profile_region("probe/idle"), contextlib.nullcontext)  # no profiler


def test_region_ms_attributes_device_work_through_its_launch():
    """A device event counts for the span in whose CPU time its launch call
    (same correlation id) lies, also when no op links it (a ctypes launch);
    the span's own device-side annotation is not work."""
    class Span:
        def __init__(self, start, end):
            self.start, self.end = start, end

        def elapsed_us(self):
            return self.end - self.start

    def ev(name, dev, eid, start, end, annotation=False):
        return SimpleNamespace(name=name, device_type=dev, id=eid,
                               time_range=Span(start, end), is_user_annotation=annotation,
                               device_time_total=end - start if dev != CPU else 0,
                               cpu_time_total=end - start if dev == CPU else 0)

    events = [
        ev("epcnet/knn_graph", CPU, 1, 0, 10),
        ev("cudaLaunchKernel", CPU, 101, 2, 3),
        ev("knn_adj_kernel", CUDA, 101, 20, 520),
        ev("epcnet/lift", CPU, 2, 10, 30),
        ev("cuLaunchKernel", CPU, 102, 12, 13),
        ev("gemm", CUDA, 102, 520, 820),
        ev("epcnet/lift", CUDA, 3, 520, 820, annotation=True),
        ev("epcnet/lift", CPU, 4, 40, 50),  # a second call, nothing launched
    ]
    got = region_ms(SimpleNamespace(events=lambda: events), "epcnet/")
    assert got == {"epcnet/knn_graph": {"count": 1, "total_ms": 0.5},
                   "epcnet/lift": {"count": 2, "total_ms": 0.3}}


def test_assert_all_finite_names_paths():
    tree = {"a": torch.ones(3), "b": [np.float32([1.0, np.inf]), torch.arange(3)],
            "c": {"d": torch.tensor([0.0, float("nan")]), "e": 2.0}}
    with pytest.raises(FloatingPointError, match=r"in batch: \[\"\['b'\]\[0\]\", "
                       r"\"\['c'\]\['d'\]\"\]"):
        assert_all_finite(tree, "batch")
    assert_all_finite({"a": torch.ones(2), "i": torch.tensor([1, 2])}, "ok")  # no raise
    many = {f"x{i}": torch.tensor([float("nan")]) for i in range(12)}
    with pytest.raises(FloatingPointError) as e:
        assert_all_finite(many)
    assert str(e.value).count("x") == 10  # at most 10 paths


def test_assert_all_finite_module_and_optimizer():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    assert_all_finite(model, "model")
    with torch.no_grad():
        model[1].running_var[2] = float("inf")
    with pytest.raises(FloatingPointError, match=r"\.1\.running_var"):
        assert_all_finite(model, "model")
    opt = torch.optim.Adam(model[0].parameters())
    model[0](torch.ones(2, 3)).sum().backward()
    opt.step()
    opt.state[model[0].weight]["exp_avg_sq"][0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"\.state\[0\]\['exp_avg_sq'\]"):
        assert_all_finite(opt, "optimizer")


def test_checked_step_raises_on_the_first_fault():
    model = torch.nn.Linear(3, 2)
    state = SimpleNamespace(model=model)

    def step(fault):
        def run(st, batch):
            loss = model(batch).sum()
            model.zero_grad()
            loss.backward()
            if fault == "grad":
                model.bias.grad[0] = float("inf")
            if fault == "param":
                with torch.no_grad():
                    model.weight[1, 2] = float("nan")
            return st, {"loss": loss.detach() * (float("nan") if fault == "loss" else 1.0),
                        "learning_rate": torch.tensor(float("nan"))}  # not a loss: unchecked
        return checked_step(run)

    x = torch.ones(4, 3)
    assert checked_step(lambda st, b: (st, {"loss": torch.tensor(1.0)}))(state, x)[0] is state
    for fault, what in (("loss", r"loss: \[\"\['loss'\]"), ("grad", r"gradients: \[\"\['bias'\]"),
                        ("param", r"model: \[\'\.weight\'")):
        with pytest.raises(FloatingPointError, match=what):
            step(fault)(state, x)
        with torch.no_grad():
            model.weight.nan_to_num_(0.0)
