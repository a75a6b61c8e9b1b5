"""The capacity ladders and the batch sweep (``epcnet_torch/scripts/
capacity.py``, ``batch_sweep.py``) on the CPU at a tiny size, held against
the JAX package: the golden small EPC-Net (``GOLDEN_KW``) at N=256 and 512,
from the port's seeded weights (``init_flat_variables``, carried to JAX as
numpy), on the same seeded clouds.

Tolerances are the ones the port's tests already state:

- a ladder rung's first loss against JAX's ``build_train_step`` in fp32:
  ``tests/test_torch_train_step.py`` ``TOL["fp32"]["loss"]`` (5e-6), the
  same for remat and accumulation;
- descriptors against JAX's model in fp32: ``tests/test_torch_models.py``'s
  1e-5, and 2e-5 on the gather route (its sums run in another order);
  in bf16 2e-4;
- the routes against each other: ``capacity.ROUTE_TOL`` (1e-3, as
  ``chip_smoke.py``), and in fp32 the gather tolerance;
- the batch sweep's descriptor across B: ``batch_sweep.BATCH_TOL`` (1e-5).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu import configs as jcfg
from epcnet_tpu.models import get_model as j_get_model
from epcnet_tpu.train.step import build_train_step as j_build_train_step

from epcnet_torch.scripts import batch_sweep, capacity, train_bench
from epcnet_torch.scripts.train_bench import blob_submaps, tuple_batch
from epcnet_torch.weights import init_flat_variables
from test_torch_models import BF16_TOL, FP32_TOL, GATHER_FP32_TOL, _cfgs, _unflatten
from test_torch_train_step import TOL, jax_state, one_torch_thread  # noqa: F401

N = 256


def jax_descriptors(jc, flat, x):
    tree = _unflatten(flat)
    return np.asarray(j_get_model(jc).apply(tree, jnp.asarray(x), train=False))


@pytest.mark.parametrize("config", capacity.CONFIGS, ids=[c[0] for c in capacity.CONFIGS])
def test_ladder_first_rung_matches_jax(config):
    """Each configuration's first rung: the loss of its first step equals
    JAX's step on the same 22-cloud tuples from the same weights."""
    name, remat, accum = config
    b = 2 if accum < 4 else 4
    jc, tc = _cfgs("epcnet", num_points=N, compute_dtype="float32")
    got = capacity.train_ladder(tc, N, (b,), (config,), steps=1, dev="cpu")[name]
    assert got["max_b"] == b and got["route"] == "dense"
    row = got["rows"][0]
    assert row["b"] == b and row["clouds"] == b * capacity.TUPLE_CLOUDS
    jt = jcfg.TrainConfig(batch_num_queries=b, remat=remat, grad_accum_steps=accum)
    batch = tuple_batch(capacity.SEED, b, capacity.POS, capacity.NEG, N)
    _, jm = j_build_train_step(jc, jt)(jax_state(jc, jt, init_flat_variables(tc, 0)),
                                      {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(row["loss"], float(jm["loss"]), atol=TOL["fp32"]["loss"], rtol=0)
    assert np.isfinite(row["loss_last"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_ladder_routes_agree_and_match_jax(dtype):
    """The three routes at N=256 agree with each other, and every rung's
    descriptors equal JAX's model on the same route; the gather rungs go on
    past the listed ones at B=1."""
    jc, tc = _cfgs("epcnet", compute_dtype=dtype)
    rungs = tuple((N, 2, f) for f in ("dense", "packed", "gather")) + ((512, 1, "gather"),)
    res, descs = capacity.embed_ladder(tc, rungs, past=(1024,), reps=1, dev="cpu")
    assert [(r["n"], r["b"], r["route"]) for r in res["rows"]] == list(rungs) + [
        (1024, 1, "gather")]
    assert all(r["finite"] and r["auto_route"] == "dense" for r in res["rows"])
    fp32 = dtype == "float32"
    assert set(res["route_gap"]) == {str(N)}
    assert res["route_gap"][str(N)] <= (GATHER_FP32_TOL if fp32 else capacity.ROUTE_TOL)
    flat = init_flat_variables(tc, 0)
    for (n, fmt), got in descs.items():
        x = capacity.embed_clouds(n, got.shape[0])
        want = jax_descriptors(jc.variant(num_points=n, adjacency_format=fmt), flat, x)
        tol = (GATHER_FP32_TOL if fmt == "gather" else FP32_TOL) if fp32 else BF16_TOL
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=f"{n} {fmt}")


def test_batch_sweep_is_batch_invariant_and_matches_jax():
    jc, tc = _cfgs("epcnet", num_points=N, compute_dtype="float32")
    res, descs = batch_sweep.sweep(tc, (2, 4, 8), reps=1, dev="cpu")
    assert [r["b"] for r in res["rows"]] == [2, 4, 8] and res["route"] == "dense"
    assert res["desc_gap"] <= batch_sweep.BATCH_TOL
    x = blob_submaps(np.random.default_rng(batch_sweep.SEED), 1, N)
    want = jax_descriptors(jc, init_flat_variables(tc, 0), x)[0]
    for b, got in descs.items():
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0, err_msg=str(b))
    assert all(r["knn_ms"] > 0 and r["ops_ranked_by"] == "cpu" for r in res["rows"])


def _failing_step(monkeypatch, exc, at_b, remat=False):
    """Make the ladder's steps raise ``exc`` at B=``at_b`` of the
    configuration with ``remat``; every other step runs."""
    real = capacity.build_train_step

    def build(model_cfg, train_cfg):
        step = real(model_cfg, train_cfg)

        def wrapped(state, batch):
            if train_cfg.batch_num_queries == at_b and train_cfg.remat == remat:
                raise exc
            return step(state, batch)
        return wrapped

    monkeypatch.setattr(capacity, "build_train_step", build)


SMALL64 = train_bench.SMALL.variant(knn_k=4)


def test_oom_ends_only_its_configurations_ladder(monkeypatch):
    msg = "CUDA out of memory. Tried to allocate 2.00 GiB. " + "x" * 300
    _failing_step(monkeypatch, torch.cuda.OutOfMemoryError(msg), at_b=6)
    res = capacity.train_ladder(SMALL64, 64, (2, 4, 6, 8), capacity.CONFIGS[:2], 1, "cpu")
    base, remat = res["baseline"], res["remat"]
    assert [r["b"] for r in base["rows"]] == [2, 4, 6] and base["max_b"] == 4
    assert base["rows"][-1] == {"b": 6, "oom": True, "message": msg[:200]}
    assert not any(r.get("oom") for r in base["rows"][:2])
    assert [r["b"] for r in remat["rows"]] == [2, 4, 6, 8] and remat["max_b"] == 8
    assert base["ms_per_step_at_max_b"] == base["rows"][1]["ms_per_step"]


def test_other_errors_propagate(monkeypatch):
    _failing_step(monkeypatch, ValueError("not a memory error"), at_b=4, remat=True)
    with pytest.raises(ValueError, match="not a memory error"):
        capacity.train_ladder(SMALL64, 64, (2, 4), capacity.CONFIGS[:2], 1, "cpu")


def test_embed_past_rungs_stop_at_the_first_oom(monkeypatch):
    real = capacity.embed_rung

    def rung(cfg, flat, n, b, fmt, reps, dev):
        if n >= 512:
            raise torch.cuda.OutOfMemoryError(f"CUDA out of memory at {n}")
        return real(cfg, flat, n, b, fmt, reps, dev)

    monkeypatch.setattr(capacity, "embed_rung", rung)
    res, descs = capacity.embed_ladder(SMALL64, ((128, 1, "gather"),), past=(512, 1024),
                                       reps=1, dev="cpu")
    assert [(r["n"], bool(r.get("oom"))) for r in res["rows"]] == [(128, False), (512, True)]
    assert res["rows"][-1]["message"] == "CUDA out of memory at 512"
    assert list(descs) == [(128, "gather")] and res["route_gap"] == {}


def test_capacity_main_on_cpu(tmp_path):
    """The whole script at its tiny CPU size: host clocks, every part, the
    saved-for-backward ranking led by the dense indicator."""
    out = tmp_path / "cap.json"
    res = capacity.main(["--device", "cpu", "--out", str(out)])
    assert res["timer"] == "host" and res["device"] == "cpu"
    assert json.load(open(out)) == res
    train = res["train"]["configs"]
    assert list(train) == [c[0] for c in capacity.CONFIGS]
    assert all(c["max_b"] == 4 for c in train.values())
    assert all(r["max_memory_allocated"] is None for c in train.values() for r in c["rows"])
    sfb = res["train"]["saved_for_backward"]
    assert sfb["clouds"] == 44 and len(sfb["top"]) == 5
    assert sfb["top"][0]["largest"]["shape"] == [44, 256, 256]
    assert sfb["modules"] > 5 and sfb["saved_bytes"] > sum(r["bytes"] for r in sfb["top"])
    assert [r["n"] for r in res["giant"]["baseline"]["rows"]] == [512]
    assert res["embed"]["route_gap"]["256"] <= capacity.ROUTE_TOL
    assert [r["n"] for r in res["embed"]["rows"]][-1] == 1024


def test_batch_sweep_main_on_cpu(tmp_path):
    out = tmp_path / "bs.json"
    res = batch_sweep.main(["--device", "cpu", "--out", str(out)])
    assert res["timer"] == "host" and json.load(open(out)) == res
    assert [r["b"] for r in res["rows"]] == [2, 4, 8] and res["best_batch"] in (2, 4, 8)
    assert res["rows"][0]["max_memory_allocated"] is None
