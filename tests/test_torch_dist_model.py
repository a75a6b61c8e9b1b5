"""The port's model paths over a process group, against the JAX package:
the ring kNN, BatchNorm over the ranks, the points-sharded embed, its
distillation gradient and its tuple train step
(``tests/test_points_sharded.py`` and the ring tests of
``tests/test_multidevice.py``, ported).

Two gloo ranks on the CPU run ``tests/torch_dist_worker.py model`` once for
the module (the inputs, made here from seeds with numpy, go through an
``.npz``); the JAX side runs here on the same inputs and the same flat
weights (``init_flat_variables``). Tolerances are the JAX tests':

- ring kNN: ids exact, distances within 1e-6; on a grid full of ties the
  ids equal the single-device oracle's (``knn_jnp``: lowest index first).
  JAX's own ring breaks ties by merge order, so it is held to the oracle
  only on tie-free points.
- BatchNorm: output, input gradient and the summed parameter gradients
  within 1e-5 of JAX's single-device layer.
- embed: fp32 within 2e-4 of JAX's single-device ``EPCNet`` and of JAX's
  ``embed_points_sharded`` (the dense A @ F route against gather means),
  bf16 cosine > 0.999; pad rows change nothing (2 ranks against 1).
- distillation: loss rtol 1e-4, each gradient within 1e-3 of its leaf's
  largest (rtol 1e-3), BN statistics rtol 1e-4 / atol 1e-6, all against
  JAX's single-device train-mode forward; remat gives the same bits.
- tuple step: against JAX's dense ``build_train_step`` (lazy quadruplet,
  SGD with momentum): loss and best positive distance rtol 1e-4, each
  parameter update within 2e-3 of the largest update (or 3e-8), BN
  statistics rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu import configs as jcfg
from epcnet_tpu.cli.export import flatten_variables
from epcnet_tpu.losses import distillation_loss as j_distillation_loss
from epcnet_tpu.models import EPCNet as JEPCNet
from epcnet_tpu.models import embed_points_sharded as j_embed_points_sharded
from epcnet_tpu.models.layers import DynamicBatchNorm as JBatchNorm
from epcnet_tpu.ops.knn import knn_jnp
from epcnet_tpu.ops.retrieval import ring_knn_points as j_ring_knn_points
from epcnet_tpu.train.step import build_train_step as j_build_train_step

from epcnet_torch import configs as tcfg
from epcnet_torch.models.points_sharded import embed_points_sharded
from epcnet_torch.parallel import ProcessMesh
from epcnet_torch.weights import init_flat_variables
from test_torch_models import _unflatten
from test_torch_train_step import jax_state
from torch_dist_worker import SMALL, spawn

WORLD = 2
F32 = dict(SMALL, compute_dtype="float32")


def _inputs():
    rng = np.random.RandomState(0)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    target = u(256)
    grid = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return {
        "ring_x517": u(517, 3), "ring_x517_k": np.array(6),
        "ring_grid": (grid / 3.0).astype(np.float32), "ring_grid_k": np.array(10),
        "ring_x512": u(512, 3), "ring_x512_k": np.array(10),
        "bn_x": rng.standard_normal((8, 16, 12)).astype(np.float32),
        "bn_w": rng.standard_normal((8, 16, 12)).astype(np.float32),
        "bn_scale": rng.uniform(0.5, 1.5, 12).astype(np.float32),
        "bn_bias": rng.standard_normal(12).astype(np.float32),
        "pts128": u(128, 3), "pts91": u(91, 3), "pts120": u(120, 3),
        "distill_pts": u(128, 3), "distill_target": target / np.linalg.norm(target),
        "tuple_query": u(128, 3), "tuple_positives": u(2, 128, 3),
        "tuple_negatives": u(3, 128, 3), "tuple_other_neg": u(128, 3),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("dist_model")
    inp = _inputs()
    flat = init_flat_variables(tcfg.ModelConfig(**F32), 0)
    flat_bf16 = init_flat_variables(tcfg.ModelConfig(**SMALL), 1)
    np.savez(wd / "inputs.npz", **inp)
    np.savez(wd / "flat_f32.npz", **flat)
    np.savez(wd / "flat_bf16.npz", **flat_bf16)
    outs = spawn("model", WORLD, str(wd), timeout=240)
    return inp, flat, flat_bf16, outs


@pytest.fixture(scope="module")
def mesh8():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()).reshape(8), ("db",))


def test_ranks_agree(run):
    """Every replicated result is the same on every rank."""
    *_, outs = run
    for key, v in outs[0].items():
        if not key.startswith("bn_"):  # BN's output and input gradient are per rank
            np.testing.assert_array_equal(outs[1][key], v, err_msg=key)


@pytest.mark.parametrize("name", ["ring_x517", "ring_grid", "ring_x512"])
def test_ring_knn_matches_oracle(run, name):
    inp, *_, outs = run
    k = int(inp[f"{name}_k"])
    want_i, want_d = knn_jnp(jnp.asarray(inp[name])[None], k, return_dists=True)
    np.testing.assert_array_equal(outs[0][f"{name}_idx"], np.asarray(want_i[0]))
    np.testing.assert_allclose(outs[0][f"{name}_dist"], np.asarray(want_d[0]), atol=1e-6)
    assert outs[0][f"{name}_idx"].max() < len(inp[name])  # no pad id leaks


def test_ring_knn_matches_jax_ring_tie_free(run, mesh8):
    inp, *_, outs = run
    got = j_ring_knn_points(jnp.asarray(inp["ring_x517"]), 6, mesh8)
    np.testing.assert_array_equal(outs[0]["ring_x517_idx"], np.asarray(got[0]))


def test_batchnorm_over_ranks_matches_jax(run):
    inp, *_, outs = run
    x, w = jnp.asarray(inp["bn_x"]), jnp.asarray(inp["bn_w"])
    c = x.shape[-1]
    bs = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

    def f(x, params):
        y, _ = JBatchNorm().apply({"params": params, "batch_stats": bs}, x, False, 0.9,
                                  mutable=["batch_stats"])
        return jnp.sum(y * w), y

    params = {"scale": jnp.asarray(inp["bn_scale"]), "bias": jnp.asarray(inp["bn_bias"])}
    (_, y), (dx, dp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(x, params)
    cat = lambda key: np.concatenate([o[key] for o in outs])  # noqa: E731
    np.testing.assert_allclose(cat("bn_y"), np.asarray(y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cat("bn_dx"), np.asarray(dx), atol=1e-5, rtol=0)
    for key in ("scale", "bias"):
        got = sum(o[f"bn_d{key}"] for o in outs)  # each rank's share of the gradient
        np.testing.assert_allclose(got, np.asarray(dp[key]), atol=1e-4, rtol=1e-5)
    flat_x = inp["bn_x"].reshape(-1, c)
    for o in outs:  # the same statistics on every rank
        np.testing.assert_allclose(o["bn_mean"], flat_x.mean(0), atol=1e-6)
        np.testing.assert_allclose(o["bn_var"], flat_x.var(0), atol=1e-5)


@pytest.mark.parametrize("n", [128, 91])
def test_embed_f32_matches_jax(run, n):
    inp, flat, _, outs = run
    variables = _unflatten(flat)
    pts = jnp.asarray(inp[f"pts{n}"])
    ref = np.asarray(JEPCNet(jcfg.ModelConfig(**F32)).apply(variables, pts[None])[0])
    got = outs[0][f"embed_f32_n{n}"]
    assert got.shape == (256,)
    np.testing.assert_allclose(got, ref, atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=1e-5)


def test_embed_f32_matches_jax_points_sharded(run, mesh8):
    inp, flat, _, outs = run
    want = j_embed_points_sharded(_unflatten(flat), jnp.asarray(inp["pts128"]),
                                  jcfg.ModelConfig(**F32), mesh8)
    np.testing.assert_allclose(outs[0]["embed_f32_n128"], np.asarray(want), atol=2e-4)


def test_embed_bf16_cosine(run):
    inp, _, flat_bf16, outs = run
    ref = np.asarray(JEPCNet(jcfg.ModelConfig(**SMALL)).apply(
        _unflatten(flat_bf16), jnp.asarray(inp["pts120"])[None])[0])
    got = outs[0]["embed_bf16_n120"]
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos > 0.999, cos


def test_pad_points_do_not_leak(run):
    """n=91 over 2 ranks (1 pad row) against one process with no group (no
    pad row)."""
    inp, flat, _, outs = run
    one = embed_points_sharded(flat, inp["pts91"], tcfg.ModelConfig(**F32), ProcessMesh(),
                               device="cpu").numpy()
    np.testing.assert_allclose(outs[0]["embed_f32_n91"], one, atol=2e-4)


def test_k_exceeds_shard_raises(run):
    *_, outs = run
    assert bool(outs[0]["k_exceeds_raised"])
    with pytest.raises(ValueError, match="exceeds points-per-shard"):
        embed_points_sharded(run[1], run[0]["pts128"][:16],
                             tcfg.ModelConfig(**F32).variant(knn_k=20), ProcessMesh(),
                             device="cpu")


def _jax_distill(inp, flat):
    model = JEPCNet(jcfg.ModelConfig(**F32))
    v = _unflatten(flat)
    pts, target = jnp.asarray(inp["distill_pts"]), jnp.asarray(inp["distill_target"])

    def loss_fn(params):
        desc, upd = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                                pts[None], train=True, momentum=0.9, mutable=["batch_stats"])
        return j_distillation_loss(desc[0], target), upd["batch_stats"]

    (loss, stats), g = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    return float(loss), flatten_variables(g, None), flatten_variables({}, stats)


def test_distill_grads_match_jax(run):
    inp, flat, _, outs = run
    loss, grads, stats = _jax_distill(inp, flat)
    o = outs[0]
    np.testing.assert_allclose(float(o["distill_plain_loss"]), loss, rtol=1e-4)
    assert sorted(k for k in o if k.startswith("distill_plain_grad/")) == \
        sorted(f"distill_plain_grad/{k}" for k in grads)
    for key, want in grads.items():
        got = o[f"distill_plain_grad/{key}"]
        atol = max(1e-6, 1e-3 * float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol, err_msg=key)
    for key, want in stats.items():
        np.testing.assert_allclose(o[f"distill_plain_var/{key}"], want, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_remat_points_sharded_exact(run):
    *_, outs = run
    o = outs[0]
    for prefix in ("distill_{}_loss", "tuple_{}_loss"):
        np.testing.assert_array_equal(o[prefix.format("remat")], o[prefix.format("plain")])
    for key in o:
        if key.startswith(("distill_plain_", "tuple_plain_var/")):
            np.testing.assert_array_equal(o[key.replace("plain", "remat", 1)], o[key],
                                          err_msg=key)


def test_tuple_train_step_matches_jax(run):
    inp, flat, _, outs = run
    jc = jcfg.ModelConfig(**F32)
    jt = jcfg.TrainConfig(loss="lazy_quadruplet", optimizer="momentum")
    state0 = jax_state(jc, jt, flat)
    batch = {k: jnp.asarray(inp[f"tuple_{k}"])[None]
             for k in ("query", "positives", "negatives", "other_neg")}
    js, jm = j_build_train_step(jc, jt)(state0, batch)
    o = outs[0]
    np.testing.assert_allclose(float(o["tuple_plain_loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(o["tuple_plain_best_pos"]), float(jm["best_pos_dist"]),
                               rtol=1e-4)
    assert bool(o["accum_raised"])
    new = flatten_variables(js.params, js.batch_stats)
    for key, want in new.items():
        got = o[f"tuple_plain_var/{key}"]
        if key.startswith("params/"):
            da, db = want - flat[key], got - flat[key]
            err = np.abs(da - db).max()
            assert err <= max(2e-3 * np.abs(da).max(), 3e-8), (key, err, np.abs(da).max())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=key)
