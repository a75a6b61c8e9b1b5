"""MinkLoc3Dv2's reference, weights and counts, and the two cells this
configuration and the packed route brought, on the CPU at a tiny size: the
benchmark's reference against the tests' copy (equal) and the port, the
weights' leaves against the port's module, ``counts_sparse`` against a
brute-force count, and a run of each cell correct, with the control and a
planted fault (an offset dropped from a kernel map, voxels floored at 0.02)
not."""

from __future__ import annotations

import importlib.util
import itertools
import time

import numpy as np
import pytest
import torch

from bench_h100 import counts_sparse, data, harness
from bench_h100.program import model_config, place_index
from bench_h100.reference import minkloc3dv2 as ref
from bench_h100.reference.precision import CONTROL
from bench_h100.tests.test_bench_h100_faults import SEED, _altered_embed
from bench_h100.weights_minkloc3dv2 import leaves, make_weights

MODEL = harness.load_json(harness.HERE, "configs", "minkloc3dv2.json")["model"]
CELL = "minkloc3dv2.embed.map_b32"


def tiny(**kw):
    return {**MODEL, "num_points": 512, **kw}


def _tests_copy():
    path = harness.ROOT + "/tests/plain_minkloc3dv2.py"
    spec = importlib.util.spec_from_file_location("plain_minkloc3dv2", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_leaves_are_the_ports():
    from epcnet_torch.models import get_model

    port = get_model(model_config(MODEL), "cpu")
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: shape for k, shape, _ in leaves(MODEL)} == want
    assert sum(int(np.prod(s)) for k, s, _ in leaves(MODEL)
               if not k.endswith((".mean", ".var"))) == 2_663_567


def test_reference_equals_the_tests_copy():
    """The two copies of the plain reference give the same descriptors and
    counts, bit for bit."""
    plain = _tests_copy()
    w = make_weights(tiny(), 3, "cpu")
    x = torch.as_tensor(data.blob_submaps(np.random.default_rng(2), 2, 512))
    with torch.no_grad():
        assert torch.equal(ref.forward(w, x), plain.forward(w, x))
    assert ref.counts(x) == plain.counts(x)


def test_forward_matches_the_port():
    """fp32: the same mathematics, within fp32's rounding (relative 1e-6);
    bf16 within 6e-3 (the CPU tests' limit), the control (fp8 operands) more
    than 5x the port's gap."""
    pts = data.blob_submaps(np.random.default_rng(1), 3, 512)
    w = make_weights(tiny(), 5, "cpu")
    want = ref.embed(w, tiny(), pts, "cpu")

    def gap(got):
        return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())

    got32 = torch.as_tensor(place_index(tiny(compute_dtype="float32"), w, "cpu", batch=4,
                                        max_k=1).embed(pts))
    got16 = torch.as_tensor(place_index(tiny(), w, "cpu", batch=4, max_k=1).embed(pts))
    ctl = ref.embed(w, tiny(), pts, "cpu", p=CONTROL)
    assert gap(got32) < 1e-6
    assert gap(got16) < 6e-3 and gap(ctl) > 5 * gap(got16)


def _brute(points: np.ndarray) -> dict:
    """Voxels and pairs by Python sets, one cloud and one voxel at a time."""
    step = np.float32(0.01)
    pairs: dict = {}
    voxels: dict = {}
    for b, cloud in enumerate(points):
        v = {tuple(int(c) for c in np.floor(p / step)) for p in cloud.astype(np.float32)}
        by_s = {1: v}
        for s in (1, 2, 4, 8):
            by_s[2 * s] = {tuple((c // (2 * s)) * (2 * s) for c in u) for u in by_s[s]}
        for s, vs in by_s.items():
            voxels[s] = voxels.get(s, 0) + len(vs)

        def odd(vs, s, size):
            r = range(-(size // 2), size // 2 + 1)
            return sum((u[0] + dx * s, u[1] + dy * s, u[2] + dz * s) in vs
                       for u in vs for dx, dy, dz in itertools.product(r, r, r))

        counted = {"conv0": odd(by_s[1], 1, 5)}
        for i in range(4):
            counted[f"down_{i}"] = len(by_s[2 ** i])
            counted[f"block_{i}"] = odd(by_s[2 ** (i + 1)], 2 ** (i + 1), 3)
        counted["up_0"], counted["up_1"] = len(by_s[8]), len(by_s[4])
        for k, n in counted.items():
            pairs[k] = pairs.get(k, 0) + n
    return {"voxels": voxels, "pairs": pairs}


def test_counts_by_brute_force():
    """``counts_sparse`` against Python sets on a tiny pool (with points
    below 0, where floor and truncation part), and the operations and bytes
    of a convolution by hand."""
    pool = data.blob_submaps(np.random.default_rng(6), 3, 200)
    brute = _brute(pool)
    work = counts_sparse.batch_work(MODEL, pool, 3, "cpu")
    assert work["voxels"] == brute["voxels"]
    assert work["pairs"] == brute["pairs"]
    conv = {c["conv"]: c for c in work["convs"]}
    assert len(conv) == 15
    p, v = brute["pairs"], brute["voxels"]
    assert conv["block_1.conv2"]["bf16_flops"] == 2 * p["block_1"] * 128 * 128
    assert conv["block_1.conv2"]["bytes"] == 2 * (v[4] * 128 + 27 * 128 * 128 + v[4] * 128)
    assert conv["tconv_1"]["bf16_flops"] == 2 * v[4] * 256 * 256
    assert conv["conv0"]["bytes"] == 2 * (v[1] + 125 * 64 + v[1] * 64)
    dense = {c["conv"]: c["bf16_flops"] for c in work["dense"]}
    assert dense == {"block_1.downsample": 2 * v[4] * 64 * 128,
                     "block_2.downsample": 2 * v[8] * 128 * 64,
                     "block_3.downsample": 2 * v[16] * 64 * 32,
                     "conv1x1_0": 2 * v[16] * 32 * 256, "conv1x1_1": 2 * v[8] * 64 * 256,
                     "conv1x1_2": 2 * v[4] * 128 * 256}
    half = counts_sparse.batch_work(MODEL, pool, 1, "cpu")  # a batch of 1: a third
    assert half["pairs"]["block_0"] == pytest.approx(p["block_0"] / 3)


def _run(name, broken=None, control=False, model_kw=None, params=None, trace=False):
    cell = harness.Cell(name)
    model = {**cell.config["model"], "num_points": 512, **(model_kw or {})}
    kind = cell.kind("cpu", SEED, control=control, model=model,
                     params=params or {"batch": 4, "pool": 8})
    if broken is not None:
        setup = kind.setup

        def broken_setup():
            setup()
            broken(kind)

        kind.setup = broken_setup
    return harness.run_cell(cell, SEED, 0.3, trace, "cpu", time.perf_counter(), kind=kind)


def test_sparse_cell_correct_with_the_programs_counters():
    out = _run(CELL)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["metrics"]["embed_submaps_per_s"]["value"] > 0
    counters = out["info"]["counters"]
    assert counters["forwards"] == out["attempted"] // 4
    assert set(counters["pairs"]) == {
        "conv0", "up_0", "up_1", *(f"{p}_{i}" for p in ("down", "block") for i in range(4))}
    assert counters["voxels"][1] > counters["voxels"][16] > 0


def test_traced_sparse_cell_reads_every_span_eagerly():
    """A traced run's ``span_ms`` holds each of the model's spans once (the
    eager forwards after the window; the CPU has no device time to give
    them), and the window's counters leave those forwards out."""
    out = _run(CELL, params={"batch": 4, "pool": 8, "trace_skip": 0, "trace_units": 1},
               trace=True)
    assert out["correct"], out["check"]
    counters = out["info"]["counters"]
    assert set(counters["span_ms"]) == {
        "minkloc/voxelize", "minkloc/kmap", "minkloc/conv0", "minkloc/gem",
        *(f"minkloc/{p}_{i}" for p in ("down", "block") for i in range(4)),
        "minkloc/up_0", "minkloc/up_1"}
    assert counters["forwards"] == out["attempted"] // 4


def _swapped(kind):
    """The first two descriptors of each batch come out swapped (each
    another submap's). Swapping two entries of one descriptor, the unit-norm
    cells' fault, moves these O(1)-valued descriptors by about the limit."""
    embed = kind.index._embed

    def swapped(points):
        out = embed(points).clone()
        out[[0, 1]] = out[[1, 0]]
        return out

    kind.index._embed = swapped


def _drop_offset(kind):
    """Offset 12, (0, 0, -1), dropped from block_0's 3³ map."""
    model = kind.index._embed.model
    real = model.build_maps

    def dropped(coords):
        maps = real(coords)
        maps["block_0"].nbr[:, 12] = -1
        return maps

    model.build_maps = dropped


@pytest.mark.parametrize("fault", ["swapped", "drop_offset", "step_002", "control"])
def test_sparse_cell_faults_are_not_correct(fault, monkeypatch):
    if fault == "step_002":
        from epcnet_torch.models import minkloc

        monkeypatch.setattr(minkloc, "QUANTIZATION_STEP", 0.02)
    broken = {"swapped": _swapped, "drop_offset": _drop_offset}.get(fault)
    out = _run(CELL, broken=broken, control=fault == "control")
    assert not out["correct"], out["check"]


def test_packed_cell_correct_and_altered_not():
    """The packed route at a size the CPU runs (asked for: ``auto`` takes it
    past N=16384 only)."""
    kw = {"model_kw": {"adjacency_format": "packed"},
          "params": {"batch": 2, "pool": 4, "num_points": 512}}
    out = _run("epcnet.embed.packed_n32768", **kw)
    assert out["correct"], out["check"]
    bad = _run("epcnet.embed.packed_n32768", broken=_altered_embed, **kw)
    assert not bad["correct"], bad["check"]


def test_packed_cell_takes_the_packed_route():
    from epcnet_torch.models.epcnet import adjacency_route

    cell = harness.Cell("epcnet.embed.packed_n32768")
    kind = cell.kind("cpu", SEED)
    assert kind.model["num_points"] == 32768
    assert adjacency_route(model_config(kind.model), 32768) == "packed"
