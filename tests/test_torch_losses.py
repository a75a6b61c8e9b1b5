"""The port's training pieces that need no model against the JAX package on
the CPU: the five losses (values and gradients, ties included), the
learning-rate and BN-momentum schedules, BatchNorm's train mode with its
deferred running update, the fp32-sum product's backward, the JSONL metrics
logger and the preemption guard.

Tolerances: loss values within 5e-6 relative and their gradients within
1e-6 absolute (fp32 sums in another order; over 8 seeds of every loss,
with and without ties, the worst gaps were 6.2e-7 relative and 2.4e-7);
schedules exactly (both are float32 arithmetic); BN outputs, input
gradients and running statistics within 5e-6 absolute (inputs of scale
~3; over 8 seeds of both shapes the worst gaps were 7.2e-7, 2.4e-7 and
1.4e-6).
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu import configs as jcfg
from epcnet_tpu import losses as jl
from epcnet_tpu.models.layers import DynamicBatchNorm as JBN
from epcnet_tpu.models.layers import SharedMLP as JSharedMLP
from epcnet_tpu.models.layers import TNet as JTNet
from epcnet_tpu.cli.export import flatten_variables
from epcnet_tpu.train.state import bn_momentum_schedule as j_bn_mom
from epcnet_tpu.train.state import lr_schedule as j_lr

from epcnet_torch import configs as tcfg
from epcnet_torch import losses as tl
from epcnet_torch.models.layers import DynamicBatchNorm, SharedMLP, TNet, commit_batch_stats
from epcnet_torch.ops.matmul import matmul_f32acc
from epcnet_torch.parallel import PreemptionGuard
from epcnet_torch.train.state import bn_momentum_schedule, lr_schedule
from epcnet_torch.utils.logging import MetricsLogger
from epcnet_torch.weights import flat_grads, flat_variables, load_flat_variables
from test_torch_models import _seeded_stats
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse)

LOSS_RTOL = 5e-6
GRAD_TOL = 1e-6
BN_TOL = 5e-6


def _descs(seed, b=3, p=2, ng=5, d=16, tie=False):
    rng = np.random.default_rng(seed)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
    q = unit(rng.standard_normal((b, d)))
    pos = unit(q[:, None] + 0.6 * rng.standard_normal((b, p, d)))
    neg = unit(q[:, None] + 0.9 * rng.standard_normal((b, ng, d)))
    other = unit(rng.standard_normal((b, d)))
    if tie:  # the loader repeats negatives when a pool is short
        neg[:, 3] = neg[:, 1]
        neg[:, 4] = neg[:, 1]
        pos[:, 1] = pos[:, 0]
    return q, pos, neg, other


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("name", ["triplet", "lazy_triplet", "quadruplet", "lazy_quadruplet",
                                  "distillation"])
def test_loss_and_grads_match_jax(name, tie):
    for seed in range(3):
        args = _descs(seed, tie=tie)
        if name == "distillation":
            args = (args[1].reshape(-1, 16), args[2][:, :2].reshape(-1, 16))
            jf, tf = jl.distillation_loss, tl.distillation_loss
        else:
            if "quadruplet" not in name:
                args = args[:3]
            jf, tf = jl.get_loss(name), tl.get_loss(name)
        want, jgrads = jax.jit(jax.value_and_grad(jf, argnums=tuple(range(len(args)))))(
            *map(jnp.asarray, args))
        ts = [torch.tensor(a, requires_grad=True) for a in args]
        got = tf(*ts)
        got.backward()
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL, atol=0)
        for t, g in zip(ts, jgrads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=GRAD_TOL, rtol=0)
        if tie and name.startswith("lazy"):
            # jnp.max splits the gradient among the three tied negatives
            g_neg = ts[2].grad.numpy()
            np.testing.assert_allclose(g_neg[:, 3], g_neg[:, 1], atol=0, rtol=0)


def test_best_pos_distance_and_get_loss():
    q, pos, _, _ = _descs(7, tie=True)
    np.testing.assert_allclose(tl.best_pos_distance(torch.tensor(q), torch.tensor(pos)).numpy(),
                               np.asarray(jl.best_pos_distance(jnp.asarray(q), jnp.asarray(pos))),
                               atol=GRAD_TOL, rtol=0)
    assert sorted(tl.LOSSES) == sorted(jl.LOSSES)
    with pytest.raises(ValueError, match="unknown loss"):
        tl.get_loss("contrastive")


def test_schedules_match_jax_across_staircases():
    for kw in (dict(), dict(learning_rate=1e-3, lr_decay_steps=100, lr_decay_rate=0.5,
                            bn_init_decay=0.5, bn_decay_rate=0.5, bn_decay_steps=100,
                            bn_decay_clip=0.99),
               dict(learning_rate=3e-4, lr_decay_steps=7, lr_decay_rate=0.9,
                    bn_decay_steps=3, bn_decay_rate=0.3, bn_decay_clip=0.95)):
        jc, tc = jcfg.TrainConfig(**kw), tcfg.TrainConfig(**kw)
        jlr, tlr, jbn, tbn = j_lr(jc), lr_schedule(tc), j_bn_mom(jc), bn_momentum_schedule(tc)
        steps = sorted({0, 1, 2, 3, 6, 7, 8, 99, 100, 101, 199, 200, 201, 10**4, 10**6, 10**7}
                       | {s * tc.lr_decay_steps + d for s in range(1, 4) for d in (-1, 0, 1)})
        for s in steps:
            assert tlr(s) == float(jlr(jnp.asarray(s, jnp.int32))), (kw, s)
            assert tbn(s) == float(jbn(jnp.asarray(s, jnp.int32))), (kw, s)
    t = lr_schedule(tcfg.TrainConfig(learning_rate=1e-3, lr_decay_steps=100, lr_decay_rate=0.5))
    assert t(99) == pytest.approx(1e-3) and t(100) == pytest.approx(5e-4)
    assert t(10**7) == pytest.approx(1e-5)  # the floor


@pytest.mark.parametrize("shape", [(2, 50, 12), (6, 12)])
def test_batchnorm_train_mode_matches_jax(shape):
    """Outputs (and their input gradients) use the batch statistics; the
    running update ``m·ra + (1 - m)·batch`` happens only at
    ``commit_batch_stats``, once, with the momentum the call took."""
    for seed in range(3):
        rng = np.random.RandomState(seed)
        x = (3 * rng.randn(*shape) + rng.randn(shape[-1])).astype(np.float32)
        c = shape[-1]
        jbn = JBN()
        v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), True, 0.9)
        v = {"params": {"scale": jnp.asarray(1 + 0.1 * rng.randn(c), jnp.float32),
                        "bias": jnp.asarray(0.1 * rng.randn(c), jnp.float32)},
             "batch_stats": _seeded_stats(v["batch_stats"], rng)}
        m = float(0.5 + 0.4 * rng.rand())
        ct = rng.randn(*shape).astype(np.float32)

        def f(xx):
            y, mut = jbn.apply(v, xx, False, m, mutable=["batch_stats"])
            return jnp.sum(y * ct), mut

        (_, mut), jdx = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x))
        y_want = jax.jit(lambda xx: jbn.apply(v, xx, False, m, mutable=["batch_stats"])[0])(
            jnp.asarray(x))

        bn = DynamicBatchNorm(c)
        load_flat_variables(bn, flatten_variables(v["params"], v["batch_stats"]))
        xt = torch.tensor(x, requires_grad=True)
        y = bn(xt, train=True, momentum=m)
        (y * torch.tensor(ct)).sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), atol=BN_TOL, rtol=0)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=BN_TOL, rtol=0)
        before = bn.mean.clone()
        bn(xt, train=True, momentum=m)  # a second forward (remat) records, applies nothing
        assert torch.equal(bn.mean, before)
        assert commit_batch_stats(bn) == 1 and commit_batch_stats(bn) == 0
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, leaf).numpy(),
                                       np.asarray(mut["batch_stats"][leaf]), atol=BN_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["mlp", "tnet"])
def test_shared_mlp_and_tnet_train_mode_match_jax(kind):
    """SharedMLP over [B, N, C] and TNet (whose ``fc`` runs BN over [B, C])
    in train mode: outputs, parameter gradients and the new statistics.
    Over 8 seeds the worst gaps were, for the MLP and the T-Net: outputs
    7.7e-7 and 1.4e-6; gradients 5.9e-7 and 4.7e-5 of the largest gradient
    (the T-Net's ``fc`` normalises over only B=4 clouds); statistics 1.2e-7
    and 3.5e-6. Held to 1e-5 (outputs), 5e-6 and 2e-4 of the largest
    gradient, and 5e-6 and 2e-5."""
    grad_tol, stat_tol = {"mlp": (5e-6, BN_TOL), "tnet": (2e-4, 2e-5)}[kind]
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (4, 40, 3)).astype(np.float32)
    jm = JSharedMLP((16, 8), dtype=jnp.float32) if kind == "mlp" else JTNet(3, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), False, 0.9)
    v = {"params": v["params"], "batch_stats": _seeded_stats(v["batch_stats"], rng)}
    if kind == "tnet":  # zero at init: seed it so the transform does work
        v["params"]["transform_w"] = jnp.asarray(
            rng.normal(0, 0.1 / 16, v["params"]["transform_w"].shape).astype(np.float32))
    out_shape = (4, 3, 3) if kind == "tnet" else (4, 40, 8)
    ct = rng.randn(*out_shape).astype(np.float32)

    def f(p):
        y, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
                          True, 0.7, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, mut)

    (_, (y_want, mut)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"])
    tm = SharedMLP(3, (16, 8), torch.float32) if kind == "mlp" else TNet(3, torch.float32)
    load_flat_variables(tm, flatten_variables(v["params"], v["batch_stats"]))
    y = tm(torch.tensor(x), True, 0.7)
    (y * torch.tensor(ct)).sum().backward()
    commit_batch_stats(tm)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), atol=1e-5, rtol=0)
    want_g, got_g = flatten_variables(jg, None), flat_grads(tm)
    gmax = max(np.abs(g).max() for g in want_g.values())
    for k, g in want_g.items():
        np.testing.assert_allclose(got_g[k], g, atol=grad_tol * gmax, rtol=0, err_msg=k)
    want_s = flatten_variables({}, mut["batch_stats"])
    got_s = flat_variables(tm)
    for k, s in want_s.items():
        np.testing.assert_allclose(got_s[k], s, atol=stat_tol, rtol=0, err_msg=k)


def test_matmul_f32acc_backward_on_cpu():
    """On the CPU the product widens to fp32 and autograd derives JAX's
    transpose: each gradient an fp32 product rounded once to its operand's
    dtype (the card's ``autograd.Function`` is held to fp32 in
    tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(0)
    a = torch.tensor((rng.random((2, 9, 9)) < 0.3).astype(np.float32)).bfloat16()
    b = torch.tensor(rng.standard_normal((2, 9, 5)), dtype=torch.bfloat16, requires_grad=True)
    g = torch.tensor(rng.standard_normal((2, 9, 5)), dtype=torch.float32)
    out = matmul_f32acc(a, b)
    assert out.dtype == torch.float32
    out.backward(g)
    want = (a.float().transpose(1, 2) @ g).bfloat16()
    assert b.grad.dtype == torch.bfloat16 and torch.equal(b.grad, want)


def test_metrics_logger_jsonl(tmp_path, monkeypatch):
    ml = MetricsLogger(str(tmp_path), "train")
    ml.write(3, {"loss": torch.tensor(0.5), "tag": "x"}, epoch=1)
    ml.flush()
    ml.close()
    rec = json.loads(open(tmp_path / "train.jsonl").read())
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["epoch"] == 1 and rec["tag"] == "x"
    # no TensorBoard backend: JSONL only, with a notice
    import builtins

    real_import = builtins.__import__

    def no_tb(name, *a, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tb)
    ml = MetricsLogger(str(tmp_path), "tb", tensorboard=True)
    ml.write(1, {"loss": 1.0})
    ml.close()
    assert os.path.isfile(tmp_path / "tb.jsonl") and not os.path.isdir(tmp_path / "tb")


def test_preemption_guard():
    with PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
        assert not guard()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard()
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGUSR1)
    assert signal.getsignal(signal.SIGUSR1) == signal.SIG_DFL
