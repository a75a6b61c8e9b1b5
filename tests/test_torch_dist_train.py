"""Data-parallel training of the port over a process group, against the
JAX package's single-device step (``tests/test_multidevice.py::
test_dp_train_step_matches_single_device``, ported).

``tests/torch_dist_worker.py dp`` runs on 2 and on 4 gloo ranks on the CPU:
each rank takes its block of the 8-tuple batch, BatchNorm's statistics span
the global batch and the gradients are averaged over the ranks. One step
(fp32, SGD with momentum: Adam's rescaling amplifies reduction-order noise,
as the JAX test notes) must equal JAX's single-device step on the whole
batch within the JAX test's bounds: loss rel 1e-4, parameters atol 1e-4;
also with ``grad_accum_steps=2`` (micro j of rank r: its local tuples
``j::2``, JAX's interleaved split restricted to the rank's block). The
multi-step dispatch and a distillation step are held to the port's own
single-device steps (themselves held to JAX's in
``tests/test_torch_train_variants.py``) within the same bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from epcnet_tpu import configs as jcfg
from epcnet_tpu.cli.export import flatten_variables
from epcnet_tpu.train.step import build_train_step as j_build_train_step

from epcnet_torch import configs as tcfg
from epcnet_torch.models import get_model
from epcnet_torch.train.state import create_train_state
from epcnet_torch.train.step import (
    build_distill_step,
    build_multi_train_step,
    build_train_step,
)
from epcnet_torch.weights import flat_variables, init_flat_variables, load_flat_variables
from test_torch_train_step import jax_state, one_torch_thread  # noqa: F401 (autouse)
from torch_dist_worker import LR, SMALL, spawn

F32 = dict(SMALL, compute_dtype="float32")
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4  # tests/test_multidevice.py:52,57
KEYS = ("query", "positives", "negatives", "other_neg")


def _batch():
    rng = np.random.RandomState(0)
    shapes = {"query": (8, 128, 3), "positives": (8, 2, 128, 3),
              "negatives": (8, 4, 128, 3), "other_neg": (8, 128, 3)}
    return {k: rng.uniform(-1, 1, s).astype(np.float32) for k, s in shapes.items()}


def _student_cfg():
    return tcfg.epcnet_l_config(num_points=128, knn_k=8, use_pallas=False,
                                compute_dtype="float32")


@pytest.fixture(scope="module", params=[2, 4], ids=["w2", "w4"])
def run(request, tmp_path_factory):
    wd = tmp_path_factory.mktemp(f"dist_dp{request.param}")
    batch = _batch()
    flat = init_flat_variables(tcfg.ModelConfig(**F32), 0)
    np.savez(wd / "inputs.npz", **{f"dp_{k}": v for k, v in batch.items()})
    np.savez(wd / "flat_f32.npz", **flat)
    np.savez(wd / "flat_student.npz", **init_flat_variables(_student_cfg(), 5))
    outs = spawn("dp", request.param, str(wd), timeout=240)
    return batch, flat, outs


def test_ranks_hold_the_same_state(run):
    *_, outs = run
    for o in outs[1:]:
        for key, v in outs[0].items():
            np.testing.assert_array_equal(o[key], v, err_msg=key)


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_step_matches_jax_single_device(run, accum):
    batch, flat, outs = run
    jc = jcfg.ModelConfig(**F32)
    jt = jcfg.TrainConfig(learning_rate=LR, optimizer="momentum", grad_accum_steps=accum)
    js, jm = j_build_train_step(jc, jt)(jax_state(jc, jt, flat),
                                        {k: jnp.asarray(v) for k, v in batch.items()})
    o = outs[0]
    np.testing.assert_allclose(float(o[f"dp_accum{accum}_loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    for key, want in flatten_variables(js.params, js.batch_stats).items():
        np.testing.assert_allclose(o[f"dp_accum{accum}_var/{key}"], want, atol=PARAM_ATOL,
                                   rtol=0, err_msg=key)


def test_dp_multi_step_matches_single_device(run):
    batch, flat, outs = run
    tt = tcfg.TrainConfig(learning_rate=LR, optimizer="momentum")
    mc = tcfg.ModelConfig(**F32)
    st = create_train_state(mc, tt, "cpu", variables=flat)
    stacked = {k: np.stack([v, v[::-1].copy()]) for k, v in batch.items()}
    st, m = build_multi_train_step(mc, tt)(st, stacked)
    o = outs[0]
    np.testing.assert_allclose(float(o["multi_loss"]), float(m["loss"]), rtol=LOSS_RTOL)
    for key, want in flat_variables(st.model).items():
        np.testing.assert_allclose(o[f"multi_var/{key}"], want, atol=PARAM_ATOL, rtol=0,
                                   err_msg=key)


def test_dp_distill_step_matches_single_device(run, tmp_path):
    batch, flat, outs = run
    tt = tcfg.TrainConfig(learning_rate=LR, optimizer="momentum")
    mc, sc = tcfg.ModelConfig(**F32), _student_cfg()
    teacher = get_model(mc, "cpu")
    load_flat_variables(teacher, flat)
    st = create_train_state(sc, tt, "cpu", variables=init_flat_variables(sc, 5))
    st, m = build_distill_step(sc, mc, tt, alpha=2.0)(st, teacher, batch)
    o = outs[0]
    np.testing.assert_allclose(float(o["distill_loss"]), float(m["loss"]), rtol=LOSS_RTOL)
    for key, want in flat_variables(st.model).items():
        np.testing.assert_allclose(o[f"distill_var/{key}"], want, atol=PARAM_ATOL, rtol=0,
                                   err_msg=key)


def test_dp_step_without_a_group_is_the_single_device_step():
    """A world of one (no process group): the DP step is the plain step."""
    from epcnet_torch.parallel import ProcessMesh

    batch, mc = _batch(), tcfg.ModelConfig(**F32)
    tt = tcfg.TrainConfig(learning_rate=LR, optimizer="momentum")
    flat = init_flat_variables(mc, 0)
    a = create_train_state(mc, tt, "cpu", variables=flat)
    b = create_train_state(mc, tt, "cpu", variables=flat)
    a, ma = build_train_step(mc, tt)(a, batch)
    b, mb = build_train_step(mc, tt, ProcessMesh().group("data"))(b, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    fa, fb = flat_variables(a.model), flat_variables(b.model)
    for key in fa:
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)
