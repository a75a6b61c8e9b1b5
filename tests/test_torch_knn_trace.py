"""The kNN trace path of the port on the CPU against the JAX trace script
``scripts/hw_knn_trace.py``: K5's plain version against ``_phase_call`` and
K6's against ``_pipelined_call``, whose Pallas kernels run in interpret
mode, as the JAX package's tests run its kernels on the CPU; and the port's
script ``epcnet_torch.scripts.knn_trace`` at a tiny size.

The script is loaded from its file, and its module-level ``pl`` is swapped
for a shim whose ``pallas_call`` runs in interpret mode; no JAX file
changes. Inputs are numpy-seeded clouds of B=2 and N=256, a multiple of the
script's tile of 128. On a dyadic grid (multiples of 1/8) every distance is
exact in fp32, and K5 must agree bit for bit; on uniform clouds Pallas in
interpret mode may round a distance one ulp away from ``pairwise_sqdist``
(as ``tests/test_torch_knn.py`` notes for K2), so K5 is held to 2 fp32 ulp
there.
"""

import functools
import importlib.util
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from epcnet_torch.ops import knn_phases
from epcnet_torch.ops.knn import knn_adjacency
from epcnet_torch.ops.pairwise import pairwise_sqdist
from epcnet_torch.scripts import knn_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def hw():
    """``scripts/hw_knn_trace.py`` as a module, its kernels in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "hw_knn_trace", os.path.join(ROOT, "scripts", "hw_knn_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id, when=pl.when)
    return mod


def _cloud(kind, seed, b=2, n=256):
    u = np.random.default_rng(seed).uniform(-1, 1, (b, n, 3))
    if kind == "dyadic":
        u = np.round(u * 8) / 8
    elif kind == "coarse":  # coordinates in {-1, 0, 1}: 10 distinct distances
        u = np.round(u)
    return u.astype(np.float32)


def _padded(x):
    """The JAX script's input: coordinates zero-padded to 8."""
    return jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, 5))))


@pytest.mark.parametrize("thresh", [False, True])
@pytest.mark.parametrize("rounds", [1, 20])
@pytest.mark.parametrize("kind", ["dyadic", "random"])
def test_k5_plain_matches_pallas(hw, kind, rounds, thresh):
    x = _cloud(kind, seed=rounds)
    got = knn_phases.knn_phase(torch.tensor(x), rounds, thresh)
    assert got.dtype == torch.float32 and got.shape == (2, 256)
    want = np.asarray(hw._phase_call(_padded(x), rounds, thresh))[..., 0]
    if kind == "dyadic":
        np.testing.assert_array_equal(got.numpy(), want)
        s = torch.sort(pairwise_sqdist(torch.tensor(x)), dim=-1).values
        assert bool((s[..., 1:] == s[..., :-1]).any(-1).all())  # ties in every row
    else:
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("kind,n,rounds", [
    ("random", 128, 129),  # more rounds than points
    ("random", 128, 1000),
    ("coarse", 256, 20),  # more rounds than distinct distances
])
def test_k5_more_rounds_than_values_is_inf(hw, kind, n, rounds):
    x = _cloud(kind, seed=n, n=n)
    want = np.asarray(hw._phase_call(_padded(x), rounds, True))[..., 0] if rounds < 200 \
        else np.full((2, n), np.inf, np.float32)  # the TPU kernel unrolls every round
    for thresh in (False, True):
        got = knn_phases.knn_phase(torch.tensor(x), rounds, thresh).numpy()
        np.testing.assert_array_equal(got, want)
    assert np.isinf(want).all()


@pytest.mark.parametrize("k", [8, 20])
@pytest.mark.parametrize("kind", ["dyadic", "random"])
def test_k6_plain_matches_pallas(hw, kind, k):
    x = _cloud(kind, seed=100 + k)
    adj, proxy = knn_phases.knn_adjacency_pipelined(torch.tensor(x), k)
    assert adj.dtype == torch.int8 and adj.shape == (2, 256, 256)
    assert proxy.dtype == torch.float32 and proxy.shape == (2, 256, 3)
    j_adj, j_proxy = hw._pipelined_call(_padded(x), k)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(j_adj))
    np.testing.assert_allclose(proxy.numpy(), np.asarray(j_proxy)[..., :3],
                               rtol=1e-6, atol=1e-7)
    # K1's indicator, and not K1's bf16 proxy
    k1_adj, k1_proxy = knn_adjacency(torch.tensor(x), k, torch.bfloat16)
    assert torch.equal(adj, k1_adj)
    assert proxy.dtype != k1_proxy.dtype


def test_cpu_tensor_never_launches():
    """A CPU tensor takes the plain versions because it lies on the CPU; the
    launch counts stay put, and the kernels' wrappers refuse it."""
    x = torch.tensor(_cloud("random", 3, b=1, n=64))
    before = (knn_phases.knn_phase_cuda.launches,
              knn_phases.knn_adjacency_pipelined_cuda.launches)
    knn_phases.knn_phase(x, 3, thresh=True)
    knn_phases.knn_adjacency_pipelined(x, 5)
    assert (knn_phases.knn_phase_cuda.launches,
            knn_phases.knn_adjacency_pipelined_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_phases.knn_phase_cuda(x, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_phases.knn_adjacency_pipelined_cuda(x, 5)
    with pytest.raises(ValueError, match="rounds=0"):
        knn_phases.knn_phase(x, 0)


def test_knn_trace_script_on_cpu(tmp_path):
    out = tmp_path / "knn_trace.json"
    res = knn_trace.main(["--device", "cpu", "--b", "1", "--n", "256", "--k", "8",
                          "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["device"] == "cpu" and res["timer"] == "host"
    phases = res["phase_ms_per_batch"]
    assert sorted(phases) == ["A_slab_1round", "B_slab_krounds", "C_plus_threshold",
                              "D_full_shipped"]
    assert all(v > 0 for v in phases.values())
    attr = res["attribution_ms"]
    assert sorted(attr) == ["selection_tail_write_proxy", "slab_plus_fixed",
                            "threshold_count", "value_rounds"]
    assert attr["slab_plus_fixed"] + attr["value_rounds"] + attr["threshold_count"] \
        + attr["selection_tail_write_proxy"] == pytest.approx(phases["D_full_shipped"])
    assert res["phase_cores"] == {"A-C (K5)": "plain", "D (K1)": "plain"}
    pipe = res["pipelined"]
    assert pipe["adj_exact"] and pipe["proxy_within_1e-6_rel"]
    assert pipe["verdict"] in ("faster", "rejected")
    trace = res["trace"]
    assert trace["ranked_by"] == "cpu" and trace["forwards"] == 3 and trace["top_ops"]
    assert trace["forward_ms"] > 0
    regions = trace["regions_ms"]
    assert regions["epcnet/knn_graph"]["count"] == 3
    assert regions["epcnet/neighbor_mean"]["count"] == 9  # layers 1-3, three forwards
    for name in ("epcnet/lift", "epcnet/gvlad", "epcnet/proxyconv_0"):
        assert regions[name]["count"] == 3
    assert os.path.isfile(os.path.join(trace["dir"], "trace.json"))


def test_knn_trace_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        knn_trace.main(["--out", str(tmp_path / "never.json")])
    assert not (tmp_path / "never.json").exists()


def test_k5_plain_across_row_blocks():
    """The plain version works through the rows in blocks; a cloud that spans
    two of them (N = 1100) gives what a row at a time gives, on a dyadic grid
    where every distance, and so every sum with the count, is exact."""
    x = _cloud("dyadic", 7, b=1, n=knn_phases.PLAIN_BLOCK_ROWS + 76)
    d = pairwise_sqdist(torch.tensor(x))[0].numpy()
    for rounds in (1, 20):
        m = np.array([np.unique(row)[rounds - 1] for row in d], np.float32)
        np.testing.assert_array_equal(knn_phases.knn_phase(torch.tensor(x), rounds)[0], m)
        cnt = (d <= m[:, None]).sum(-1).astype(np.float32)
        np.testing.assert_array_equal(
            knn_phases.knn_phase(torch.tensor(x), rounds, thresh=True)[0],
            m + np.float32(1e-20) * cnt)
