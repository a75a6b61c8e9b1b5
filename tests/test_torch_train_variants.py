"""The port's step variants against the JAX package's on the CPU: gradient
accumulation (JAX's interleaved micro-batches), remat (exactly the plain
step, BN statistics applied once), ``steps_per_dispatch`` (exactly S single
steps) and the distillation step; the committed file
``tests/torch_train_step.npz`` that the card's step is held to; and the
training bench at its CPU size.

Tolerances are ``test_torch_train_step.TOL["fp32"]`` (set there from 8
seeds; the accumulated step's worst gaps over 8 seeds were 1.8e-7 loss,
2.8e-5 gradient, 7.2e-7 statistics). The distillation step's, over 8 seeds
(EPC-Net teacher, EPC-Net-L student, fp32, alpha 2): losses 9.5e-7 ->
5e-6, gradients 1.3e-5 -> 2e-4, statistics 3.6e-7 -> 5e-6, parameters
after the update 1.2e-7 -> 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from epcnet_tpu import configs as jcfg
from epcnet_tpu.cli.export import flatten_variables
from epcnet_tpu.train.step import build_distill_step as j_build_distill_step

from epcnet_torch import configs as tcfg
from epcnet_torch.models import get_model
from epcnet_torch.train.state import create_train_state
from epcnet_torch.train.step import build_distill_step, build_multi_train_step, build_train_step
from epcnet_torch.weights import flat_grads, flat_variables, init_flat_variables, load_flat_variables
from test_torch_models import _cfgs, _unflatten
from test_torch_train_step import (  # noqa: F401 (one_torch_thread: autouse)
    TOL,
    assert_grads,
    assert_loss,
    assert_params,
    assert_stats,
    first_grads,
    jax_state,
    one_torch_thread,
    run_both,
    seeded_batch,
)

# JAX's fp32 step at the golden EPC-Net width (N=128, k=8) from
# init_flat_variables(seed=0) and seeded_batch(0): loss, gradients and new
# BN statistics; tests/test_torch_cuda.py and chip_smoke.py hold the card's
# step to it. Regenerate deliberately:
#   PYTHONPATH=.:tests python tests/test_torch_train_variants.py regen-step
TRAIN_STEP_FILE = os.path.join(os.path.dirname(__file__), "torch_train_step.npz")
# XLA's CPU sums may take another order on another CPU: the recomputation is
# held to a tenth of the fp32 tolerances
REPRO = 0.1


def test_grad_accum_matches_jax():
    """grad_accum_steps=2 over B=2 tuples: micro j takes tuple j (JAX's
    interleaved split), gradients summed then halved, BN updated twice."""
    j, t = run_both("epcnet", model_kw=dict(compute_dtype="float32"), optimizer="momentum",
                    grad_accum_steps=2)
    tol = TOL["fp32"]
    assert_loss(j, t, tol["loss"])
    assert_grads(j, t, tol["grad"])
    assert_stats(j, t, tol["stats"])
    assert_params(j, t, tol["sgd"], step=1)


def _port_steps(tc, tt, batches, multi=False):
    st = create_train_state(tc, tt, "cpu", variables=init_flat_variables(tc, 1))
    if multi:
        stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        st, m = build_multi_train_step(tc, tt)(st, stacked)
        return st, m, None
    step = build_train_step(tc, tt)
    grads = None
    for b in batches:
        st, m = step(st, b)
        grads = grads or flat_grads(st.model)
    return st, m, grads


def test_remat_equals_plain_step_exactly():
    """torch.utils.checkpoint runs the forward again in backward: the same
    values, and BN's running statistics are applied once."""
    _, tc = _cfgs("epcnet", compute_dtype="float32")
    batches = [seeded_batch(s) for s in (3, 4)]
    out = {}
    for remat in (False, True):
        tt = tcfg.TrainConfig(learning_rate=1e-3, remat=remat)
        st, m, grads = _port_steps(tc, tt, batches)
        out[remat] = (flat_variables(st.model), float(m["loss"]), grads)
    for k, v in out[False][0].items():
        np.testing.assert_array_equal(out[True][0][k], v, err_msg=k)
    assert out[True][1] == out[False][1]
    for k, v in out[False][2].items():
        np.testing.assert_array_equal(out[True][2][k], v, err_msg=k)


def test_multi_step_equals_single_steps():
    _, tc = _cfgs("epcnet_l", compute_dtype="float32")
    tt = tcfg.TrainConfig(learning_rate=1e-3, steps_per_dispatch=3)
    batches = [seeded_batch(s) for s in (5, 6, 7)]
    single, m1, _ = _port_steps(tc, tt, batches)
    multi, m3, _ = _port_steps(tc, tt, batches, multi=True)
    assert single.step == multi.step == 3
    assert float(m3["loss"]) == float(m1["loss"])  # the LAST step's metrics
    a, b = flat_variables(single.model), flat_variables(multi.model)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_distill_step_matches_jax():
    jtc, ttc = _cfgs("epcnet", compute_dtype="float32")
    jsc, tsc = _cfgs("epcnet_l", compute_dtype="float32")
    kw = dict(learning_rate=1e-3, optimizer="momentum")
    jt, tt = jcfg.TrainConfig(**kw), tcfg.TrainConfig(**kw)
    t_flat, s_flat = init_flat_variables(ttc, 11), init_flat_variables(tsc, 12)
    batch = seeded_batch(2)
    js = jax_state(jsc, jt, s_flat)
    jstep = j_build_distill_step(jsc, jtc, jt, alpha=2.0)
    js, jm = jstep(js, _unflatten(t_flat), {k: jnp.asarray(v) for k, v in batch.items()})
    teacher = get_model(ttc, "cpu")
    load_flat_variables(teacher, t_flat)
    st = create_train_state(tsc, tt, "cpu", variables=s_flat)
    st, tm = build_distill_step(tsc, ttc, tt, alpha=2.0)(st, teacher, batch)
    tol = TOL["fp32"]
    for key in ("loss", "metric_loss", "mimic_loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=tol["loss"], rtol=0)
    j = {"grads": first_grads(js, "momentum"),
         "vars": [flatten_variables(js.params, js.batch_stats)]}
    t = {"grads": flat_grads(st.model), "vars": [flat_variables(st.model)]}
    assert_grads(j, t, tol["grad"])
    assert_stats(j, t, tol["stats"])
    assert_params(j, t, tol["sgd"], step=0)
    # the teacher is frozen: no gradient, statistics unchanged
    assert all(p.grad is None for p in teacher.parameters())
    np.testing.assert_array_equal(flat_variables(teacher)["batch_stats/lift/bn_0/mean"],
                                  t_flat["batch_stats/lift/bn_0/mean"])


def jax_train_step_file():
    """JAX's fp32 momentum step (the trace is the gradient) at the golden
    EPC-Net width: the file's arrays."""
    jc, tc = _cfgs("epcnet", compute_dtype="float32")
    jt = jcfg.TrainConfig(learning_rate=1e-3, optimizer="momentum")
    from epcnet_tpu.train.step import build_train_step as j_build_train_step

    flat = init_flat_variables(tc, 0)
    batch = seeded_batch(0)
    js, jm = j_build_train_step(jc, jt)(jax_state(jc, jt, flat),
                                        {k: jnp.asarray(v) for k, v in batch.items()})
    out = {f"batch/{k}": v for k, v in batch.items()}
    out.update({f"grad/{k}": v for k, v in first_grads(js, "momentum").items()})
    out.update({f"stats/{k}": v for k, v in flatten_variables({}, js.batch_stats).items()})
    out["loss"] = np.float32(jm["loss"])
    out["seed"] = np.int64(0)
    return out


def test_train_step_file_is_jax():
    """The committed file is what JAX computes, and the port's CPU step is
    within the fp32 tolerances of it."""
    data = dict(np.load(TRAIN_STEP_FILE))
    want = jax_train_step_file()
    assert sorted(data) == sorted(want)
    gmax = max(np.abs(v).max() for k, v in want.items() if k.startswith("grad/"))
    for k, v in want.items():
        tol = {"grad": TOL["fp32"]["grad"] * gmax, "stat": TOL["fp32"]["stats"],
               "loss": TOL["fp32"]["loss"]}.get(k[:4], 0.0)
        np.testing.assert_allclose(data[k], v, atol=REPRO * tol, rtol=0, err_msg=k)
    _, tc = _cfgs("epcnet", compute_dtype="float32")
    tt = tcfg.TrainConfig(learning_rate=1e-3, optimizer="momentum")
    st = create_train_state(tc, tt, "cpu", variables=init_flat_variables(tc, int(data["seed"])))
    batch = {k[6:]: v for k, v in data.items() if k.startswith("batch/")}
    st, m = build_train_step(tc, tt)(st, batch)
    j = {"grads": {k[5:]: v for k, v in data.items() if k.startswith("grad/")},
         "vars": [{k[6:]: v for k, v in data.items() if k.startswith("stats/")}],
         "metrics": [{"loss": float(data["loss"])}]}
    t = {"grads": flat_grads(st.model), "vars": [flat_variables(st.model)],
         "metrics": [{"loss": float(m["loss"])}]}
    assert_loss(j, t, TOL["fp32"]["loss"])
    assert_grads(j, t, TOL["fp32"]["grad"])
    assert_stats(j, t, TOL["fp32"]["stats"])


def test_train_bench_runs_on_cpu(tmp_path):
    """The training bench at its tiny CPU size (host clocks, no
    device number): every configuration steps, each span is found, remat
    runs the kNN graph twice a step, the gather entry takes the gather
    route."""
    from epcnet_torch.scripts import train_bench

    res = train_bench.main(["--device", "cpu", "--steps", "1", "--out",
                            str(tmp_path / "tb.json")])
    assert res["timer"] == "host" and json.load(open(tmp_path / "tb.json")) == res
    for name in ("dense", "dense_remat", "dense_accum2", "gather"):
        r = res[name]
        assert set(r["spans"]) == set(train_bench.SPANS), (name, r["spans"])
        assert np.isfinite(r["loss"]) and r["ms_per_step"] > 0
    assert res["dense"]["clouds"] == 44 and res["gather"]["clouds"] == 5
    assert res["gather"]["route"] == "gather" and res["dense"]["route"] == "dense"
    assert res["dense_remat"]["spans"]["epcnet/knn_graph"]["count"] == 6  # 3 steps, twice each
    assert res["dense_accum2"]["spans"]["train/backward"]["count"] == 6


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["regen-step"]:
        jax.config.update("jax_platforms", "cpu")
        np.savez(TRAIN_STEP_FILE, **jax_train_step_file())
        print(f"wrote {TRAIN_STEP_FILE}")
