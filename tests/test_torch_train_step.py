"""One train step of the port against ``epcnet_tpu.train.step.build_train_step``
on the CPU, at the golden small widths (``GOLDEN_KW``), from the same flat
weights (``init_flat_variables``) and the same seeded tuple batch: 2 tuples
of 1 query, 2 positives, 4 negatives and the other negative, N=128.

JAX's gradients are read from its optimiser state after the first update:
optax's Adam first moment is 0.1·g (to 1 float32 rounding), SGD's trace is
g. Compared: the loss, every gradient by its flat name, the new BN running
statistics, and the parameters after 2 updates.

Tolerances, from the worst gap over 8 seeds (seeds 0-7 of weights and
batch; the held seed is 0):

- EPC-Net and EPC-Net-L in fp32 (the dense and gather routes, accumulation
  and remat alike): loss 5.4e-7 -> 5e-6; gradient 2.8e-5 of
  max(the tensor's largest gradient, a tenth of the model's) -> 2e-4; BN
  statistics 7.2e-7 -> 5e-6 (after 2 SGD steps too); parameters after 2
  SGD steps 1.2e-7 -> 1e-6.
- PointNetVLAD in fp32: loss 5.8e-6 -> 5e-5; gradient 7.9e-3 -> 5e-2; BN
  9.3e-6 -> 5e-5, after 2 SGD steps 2.3e-3 -> 2e-2; SGD parameters 4.9e-4
  -> 5e-3. JAX is the less accurate
  side here: against a float64 run of the port's step, the port's fp32
  gradients are within 2e-5 of each tensor's largest and JAX's within 2e-2
  (``mlp2/bn_2/bias``, a sum that cancels to ~1% of its terms).
- Adam normalises each element's update by the gradient's own size, so an
  element whose gradient is at rounding level (exactly: the bias of a
  Dense layer that BN follows, whose gradient is zero in exact arithmetic;
  and PointNetVLAD's T-Nets, whose gradients are ~1e-8, eps's size) moves by
  up to lr a step on noise. After 2 Adam steps every element is held to the
  bound of two updates, 4·lr, and for EPC-Net(-L) all but 5e-3 of the
  elements outside those biases to 1e-5 (worst over 8 seeds: 5.1e-4). The
  noise-driven bias moves shift the next batch's BN means, so the second
  step's statistics are held only after SGD.
- EPC-Net in bf16, loss and BN statistics only: 4.7e-3 and 3.7e-3 -> 2e-2
  (jitted XLA keeps some bf16 intermediates in fp32 that eager torch rounds).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu import configs as jcfg
from epcnet_tpu.cli.export import flatten_variables
from epcnet_tpu.train.state import TrainState as JTrainState
from epcnet_tpu.train.state import make_optimizer as j_make_optimizer
from epcnet_tpu.train.step import build_train_step as j_build_train_step

from epcnet_torch import configs as tcfg
from epcnet_torch.train.state import create_train_state
from epcnet_torch.train.step import build_train_step
from epcnet_torch.weights import flat_grads, flat_variables, init_flat_variables
from test_torch_models import _cfgs, _unflatten

LR = 1e-3
TOL = {  # loss, gradient, BN statistics after 1 and 2 steps, parameters after 2 SGD steps
    "fp32": dict(loss=5e-6, grad=2e-4, stats=5e-6, stats2=5e-6, sgd=1e-6),
    "pointnetvlad": dict(loss=5e-5, grad=5e-2, stats=5e-5, stats2=2e-2, sgd=5e-3),
    "bf16": dict(loss=2e-2, stats=2e-2),
}
ADAM_ELEM_TOL, ADAM_FRACTION = 1e-5, 5e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are small: one intra-op thread runs them as fast as
    all of them and leaves the other cores to the other test workers.
    Imported by the other training test files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def seeded_batch(seed, b=2, p=2, ng=4, n=128):
    rng = np.random.default_rng(100 + seed)
    shapes = {"query": (b, n, 3), "positives": (b, p, n, 3), "negatives": (b, ng, n, 3),
              "other_neg": (b, n, 3)}
    return {k: rng.uniform(-1, 1, s).astype(np.float32) for k, s in shapes.items()}


def jax_state(jc, jt, flat):
    tree = _unflatten(flat)
    tx = j_make_optimizer(jt)
    zero = jnp.zeros((), jnp.int32)
    return JTrainState(step=zero, params=tree["params"], batch_stats=tree["batch_stats"],
                       opt_state=tx.init(tree["params"]), epoch=zero, epoch_start_step=zero,
                       tx=tx)


def first_grads(js1, optimizer):
    """JAX's first-step gradients from its optimiser state."""
    if optimizer == "adam":
        return {k: v / 0.1 for k, v in flatten_variables(js1.opt_state[0].mu, None).items()}
    return flatten_variables(js1.opt_state[0].trace, None)


def run_both(name, seed=0, model_kw=None, steps=2, **train_kw):
    """(JAX, port): per package a dict with the metrics of each step, the
    first step's gradients and the flat variables after each step."""
    jc, tc = _cfgs(name, **(model_kw or {}))
    kw = dict(learning_rate=LR, **train_kw)
    jt, tt = jcfg.TrainConfig(**kw), tcfg.TrainConfig(**kw)
    flat = init_flat_variables(tc, seed)
    batch = seeded_batch(seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep, js = j_build_train_step(jc, jt), jax_state(jc, jt, flat)
    st, tstep = create_train_state(tc, tt, "cpu", variables=flat), build_train_step(tc, tt)
    j = {"metrics": [], "vars": []}
    t = {"metrics": [], "vars": []}
    for i in range(steps):
        js, jm = jstep(js, jb)
        st, tm = tstep(st, batch)
        if i == 0:
            j["grads"], t["grads"] = first_grads(js, jt.optimizer), flat_grads(st.model)
        j["metrics"].append({k: float(v) for k, v in jm.items()})
        t["metrics"].append({k: float(v) for k, v in tm.items()})
        j["vars"].append(flatten_variables(js.params, js.batch_stats))
        t["vars"].append(flat_variables(st.model))
    assert st.step == int(js.step) == steps
    return j, t


def pre_bn_bias(name: str, names) -> bool:
    """A Dense bias that BN follows: its gradient is zero in exact arithmetic."""
    m = re.match(r"params/(.*)/dense(_\d+)?/bias$", name)
    return bool(m) and f"params/{m.group(1)}/bn{m.group(2) or ''}/scale" in names


def assert_loss(j, t, tol, step=0):
    np.testing.assert_allclose(t["metrics"][step]["loss"], j["metrics"][step]["loss"],
                               atol=tol, rtol=0)


def assert_grads(j, t, tol):
    want, got = j["grads"], t["grads"]
    assert sorted(got) == sorted(want)
    gmax = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        scale = max(np.abs(w).max(), 0.1 * gmax)
        gap = np.abs(got[k] - w).max()
        assert gap <= tol * scale, (k, gap, scale)


def assert_stats(j, t, tol, step=0):
    for k, w in j["vars"][step].items():
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(t["vars"][step][k], w, atol=tol, rtol=0, err_msg=k)


def assert_params(j, t, tol, step):
    for k, w in j["vars"][step].items():
        if k.startswith("params/"):
            np.testing.assert_allclose(t["vars"][step][k], w, atol=tol, rtol=0, err_msg=k)


def assert_adam_params(j, t, fraction):
    want, got = j["vars"][-1], t["vars"][-1]
    names = set(want)
    off = total = 0
    for k, w in want.items():
        if not k.startswith("params/"):
            continue
        gap = np.abs(got[k] - w)
        assert gap.max() <= 4 * LR, (k, gap.max())  # two Adam updates at most
        if fraction is not None and not pre_bn_bias(k, names):
            off += int((gap > ADAM_ELEM_TOL).sum())
            total += gap.size
    if fraction is not None:
        assert off <= fraction * total, (off, total)


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
@pytest.mark.parametrize("name", ["epcnet", "epcnet_l", "pointnetvlad"])
def test_fp32_step_matches_jax(name, optimizer):
    j, t = run_both(name, model_kw=dict(compute_dtype="float32"), optimizer=optimizer)
    tol = TOL["pointnetvlad" if name == "pointnetvlad" else "fp32"]
    assert_loss(j, t, tol["loss"])
    for key in ("learning_rate", "bn_momentum"):
        assert t["metrics"][0][key] == j["metrics"][0][key]
    for key in ("best_pos_dist", "min_neg_dist"):
        np.testing.assert_allclose(t["metrics"][0][key], j["metrics"][0][key],
                                   atol=tol["loss"], rtol=0)
    assert_grads(j, t, tol["grad"])
    assert_stats(j, t, tol["stats"])
    if optimizer == "momentum":
        assert_params(j, t, tol["sgd"], step=1)
        assert_stats(j, t, tol["stats2"], step=1)  # the EMA chained over two steps
    else:
        assert_adam_params(j, t, None if name == "pointnetvlad" else ADAM_FRACTION)


def test_bf16_step_matches_jax():
    j, t = run_both("epcnet", steps=1)
    assert_loss(j, t, TOL["bf16"]["loss"])
    assert_stats(j, t, TOL["bf16"]["stats"])


def test_gather_route_step_matches_jax():
    """``adjacency_format="gather"``: K2's ids and the gather mean, whose
    backward is a scatter."""
    j, t = run_both("epcnet", model_kw=dict(compute_dtype="float32",
                                            adjacency_format="gather"), optimizer="momentum")
    tol = TOL["fp32"]
    assert_loss(j, t, tol["loss"])
    assert_grads(j, t, tol["grad"])
    assert_stats(j, t, tol["stats"])
    assert_params(j, t, tol["sgd"], step=1)


def test_float64_gather_step_is_a_reference():
    """``compute_dtype="float64"`` with the model in fp64 (``model.double()``),
    the reference the chip check measures the points-sharded tuple step's
    rounding from, on the gather route (the dense route's kernels take
    bf16/fp32 only): every stage runs in fp64, and JAX's and the port's fp32
    steps both lie within the fp32 gradient tolerance of it."""
    fmt = dict(adjacency_format="gather")
    j, t = run_both("epcnet", model_kw=dict(compute_dtype="float32", **fmt),
                    optimizer="momentum", steps=1)
    _, tc = _cfgs("epcnet", compute_dtype="float64", **fmt)
    tt = tcfg.TrainConfig(learning_rate=LR, optimizer="momentum")
    st = create_train_state(tc, tt, "cpu", variables=init_flat_variables(tc, 0))
    st.model.double()
    _, m = build_train_step(tc, tt)(st, seeded_batch(0))
    assert all(p.grad.dtype == torch.float64 for p in st.model.parameters())
    ref = {"grads": flat_grads(st.model), "metrics": [{"loss": float(m["loss"])}]}
    for side in (t, j):
        assert_loss(ref, side, TOL["fp32"]["loss"])
        assert_grads(ref, side, TOL["fp32"]["grad"])
