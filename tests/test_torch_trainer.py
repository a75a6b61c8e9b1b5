"""The port's Trainer, checkpoints and training CLIs on the CPU, mirroring
``tests/test_train.py``: the loss falls; a run resumed at an epoch boundary
or in the middle of an epoch ends bit for bit where the uninterrupted run
ends (atol 1e-7, as there); checkpoints round-trip; the gather route
trains; a stop request saves a resumable checkpoint; ``cli/train`` (with
the recall hook and a profile) -> ``cli/export`` -> ``cli/evaluate`` runs,
its export loading into the JAX model with the port's descriptors (fp32,
within 1e-5); and ``cli/distill`` trains a student from a checkpoint."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu.data import construct_query_dict as j_construct_query_dict
from epcnet_tpu.data.tuples import scan_runs as j_scan_runs
from epcnet_tpu.models import get_model as j_get_model

from epcnet_torch import configs as tcfg
from epcnet_torch.cli import distill as distill_cli
from epcnet_torch.cli import evaluate as eval_cli
from epcnet_torch.cli import export as export_cli
from epcnet_torch.cli import train as train_cli
from epcnet_torch.data.tuples import TrainingTuples
from epcnet_torch.train import Trainer, create_train_state
from epcnet_torch.train.checkpoint import CheckpointManager
from epcnet_torch.weights import flat_variables, load_export
from test_torch_models import GOLDEN_KW, _cfgs, _unflatten
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse)

RESUME_ATOL = 1e-7  # tests/test_train.py:144


@pytest.fixture(scope="module")
def tuples(synthetic_root):
    return TrainingTuples(j_construct_query_dict(j_scan_runs(synthetic_root),
                                                 exclude_test_regions=False).queries)


def _cfg(root, log_dir, model=None, **train_kw):
    tkw = dict(batch_num_queries=2, max_epoch=1, learning_rate=1e-3, mining_start_epoch=99,
               log_every_steps=5, checkpoint_every_steps=10**6)
    tkw.update(train_kw)
    return tcfg.ExperimentConfig(
        model=model or tcfg.ModelConfig(**GOLDEN_KW["epcnet"]),
        data=tcfg.DataConfig(dataset_root=root, num_points=128, num_negatives=4,
                             num_positives=2),
        train=tcfg.TrainConfig(**tkw), log_dir=str(log_dir))


def _assert_same_params(a, b):
    fa, fb = flat_variables(a.model), flat_variables(b.model)
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], atol=RESUME_ATOL, rtol=0, err_msg=k)


def test_trainer_loss_decreases(tuples, synthetic_root, tmp_path):
    cfg = _cfg(synthetic_root, tmp_path, max_epoch=2)
    tr = Trainer(cfg, tuples, checkpoints=False, device="cpu")
    tr.train()
    recs = [json.loads(line) for line in open(tmp_path / "train.jsonl")]
    losses = [r["loss"] for r in recs]
    assert {"learning_rate", "bn_momentum", "best_pos_dist", "submaps_per_sec"} <= set(recs[0])
    assert np.mean(losses[len(losses) // 2:]) < np.mean(losses[:len(losses) // 2])
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        Trainer(cfg, tuples, mesh=object(), device="cpu")


def test_trainer_epoch_resume(tuples, synthetic_root, tmp_path):
    """3 epochs straight against 2 epochs -> a fresh trainer -> restore ->
    epoch 2: the same final parameters, and no epoch replayed."""
    sa = Trainer(_cfg(synthetic_root, tmp_path / "a", max_epoch=3, mining_start_epoch=1),
                 tuples, checkpoints=False, device="cpu").train()
    cfg_b = _cfg(synthetic_root, tmp_path / "b", max_epoch=2, mining_start_epoch=1)
    Trainer(cfg_b, tuples, device="cpu").train()
    cfg_c = dataclasses.replace(cfg_b, train=dataclasses.replace(cfg_b.train, max_epoch=3))
    tr_c = Trainer(cfg_c, tuples, device="cpu")
    assert tr_c.maybe_restore() == sa.step * 2 // 3
    assert tr_c.state.epoch == 2
    sc = tr_c.train()
    assert sc.step == sa.step
    _assert_same_params(sa, sc)


def test_trainer_midepoch_resume(tuples, synthetic_root, tmp_path):
    sa = Trainer(_cfg(synthetic_root, tmp_path / "a"), tuples, checkpoints=False,
                 device="cpu").train()
    cfg_b = _cfg(synthetic_root, tmp_path / "b", checkpoint_every_steps=7)
    tr_b = Trainer(cfg_b, tuples, device="cpu")

    class Killed(RuntimeError):
        pass

    real_step, calls = tr_b.step_fn, [0]

    def dying_step(state, batch):
        calls[0] += 1
        if calls[0] > 10:  # dies after the step-7 checkpoint
            raise Killed()
        return real_step(state, batch)

    tr_b.step_fn = dying_step
    with pytest.raises(Killed):
        tr_b.train()
    tr_c = Trainer(cfg_b, tuples, device="cpu")
    assert tr_c.maybe_restore() == 7
    assert tr_c.state.epoch == 0 and tr_c.state.epoch_start_step == 0
    sc = tr_c.train()
    assert sc.step == sa.step
    _assert_same_params(sa, sc)


def test_multi_step_dispatch_trainer(tuples, synthetic_root, tmp_path):
    """steps_per_dispatch=4 (with an epoch-tail remainder) ends where single
    steps end."""
    s1 = Trainer(_cfg(synthetic_root, tmp_path / "a"), tuples, checkpoints=False,
                 device="cpu").train()
    s4 = Trainer(_cfg(synthetic_root, tmp_path / "b", steps_per_dispatch=4), tuples,
                 checkpoints=False, device="cpu").train()
    assert s1.step == s4.step and s1.step % 4
    _assert_same_params(s1, s4)


def test_checkpoint_roundtrip(tmp_path):
    mc = tcfg.ModelConfig(**GOLDEN_KW["epcnet"])
    tc = tcfg.TrainConfig()
    state = create_train_state(mc, tc, "cpu")
    x = torch.rand(2, 128, 3)
    state.model(x, train=True).sum().backward()
    state.optimizer.step()  # Adam moments exist
    state.step, state.epoch, state.epoch_start_step = 7, 1, 5
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore(create_train_state(mc, tc, "cpu"), require=True)
    mgr.save(state)
    fresh = mgr.restore(create_train_state(mc, dataclasses.replace(tc, seed=99), "cpu"))
    assert (fresh.step, fresh.epoch, fresh.epoch_start_step) == (7, 1, 5)
    a, b = flat_variables(state.model), flat_variables(fresh.model)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    sa, sb = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    for i in sa:
        assert torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"])
    for s in (8, 9, 10):
        state.step = s
        mgr.save(state)
    mgr.save(state)  # a step already saved is skipped
    assert mgr.all_steps() == [9, 10]
    assert not [f for f in os.listdir(tmp_path / "ckpt") if f.endswith(".tmp")]


def test_trainer_with_gather_adjacency(tuples, synthetic_root, tmp_path):
    model = tcfg.ModelConfig(**GOLDEN_KW["epcnet"]).variant(adjacency_format="gather")
    cfg = _cfg(synthetic_root, tmp_path, model=model)
    Trainer(cfg, tuples, checkpoints=False, device="cpu").train()
    recs = [json.loads(line) for line in open(tmp_path / "train.jsonl")]
    assert recs and all(np.isfinite(r["loss"]) for r in recs)


def test_should_stop_saves_a_resumable_checkpoint(tuples, synthetic_root, tmp_path):
    cfg = _cfg(synthetic_root, tmp_path, max_epoch=2)
    tr = Trainer(cfg, tuples, device="cpu")
    polls = [0]

    def stop_after_five():
        polls[0] += 1
        return polls[0] >= 5

    st = tr.train(should_stop=stop_after_five)
    assert st.step == 5 and CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 5
    tr2 = Trainer(cfg, tuples, device="cpu")
    assert tr2.maybe_restore() == 5 and tr2.state.epoch == 0


def test_cli_train_export_evaluate_round_trip(tmp_path):
    """``cli/train --synthetic`` 2 epochs -> ``--restore`` to 3 (only epoch
    2 runs) -> ``cli/export`` -> ``cli/evaluate --device cpu``; the export
    in the JAX model gives the port's descriptors."""
    root, log = tmp_path / "data", tmp_path / "log"
    s = [f"model.{k}={v if not isinstance(v, tuple) else ','.join(map(str, v))}"
         for k, v in GOLDEN_KW["epcnet"].items() if k != "use_pallas"]
    s += ["model.compute_dtype=float32", "data.num_points=128", "data.num_negatives=3",
          "data.num_positives=1", "train.max_epoch=2", "train.mining_start_epoch=1",
          "train.log_every_steps=5", "train.checkpoint_every_steps=1000000"]
    sets = [a for x in s for a in ("--set", x)]
    base = ["--dataset_root", str(root), "--log_dir", str(log), "--device", "cpu"] + sets
    tr = train_cli.main(base + ["--synthetic", "--eval_every_epochs", "1"])
    steps2 = tr.state.step
    best = json.load(open(log / "best_recall.json"))  # the recall hook kept the best
    assert CheckpointManager(str(log / "ckpt_best")).latest_step() == best["step"] > 0
    tr = train_cli.main(base + ["--restore", "--set", "train.max_epoch=3",
                                "--profile_dir", str(tmp_path / "prof")])
    assert os.path.isfile(tmp_path / "prof" / "trace.json")
    recs = [json.loads(line) for line in open(log / "train.jsonl")]
    epochs = {r["epoch"] for r in recs if "loss" in r}
    assert epochs == {0, 1, 2} and tr.state.step == steps2 * 3 // 2
    assert [r["epoch"] for r in recs if "eval_recall_at_1" in r] == [0, 1]
    out = export_cli.main(["--log_dir", str(log)])
    cfg, flat = load_export(out)
    assert cfg.model.compute_dtype == "float32"
    res = eval_cli.main(["--dataset_root", str(root), "--log_dir", str(log), "--device", "cpu"])
    assert res["results"]["average"]["recall_at"][0] > 0
    x = np.random.default_rng(0).uniform(-1, 1, (2, 128, 3)).astype(np.float32)
    jc, _ = _cfgs("epcnet", compute_dtype="float32")
    want = np.asarray(j_get_model(jc).apply(_unflatten(flat), jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = tr.state.model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        train_cli.main(base + ["--mesh"])


def test_cli_distill_from_teacher_checkpoint(tmp_path, synthetic_root):
    """``cli/distill`` takes the teacher from its run's checkpoint (no export
    pair there) and trains the EPC-Net-L student; without a checkpoint it
    refuses."""
    teacher = tmp_path / "teacher"
    cfg = _cfg(synthetic_root, teacher)
    os.makedirs(teacher)
    with open(teacher / "config.json", "w") as f:
        f.write(cfg.to_json())
    args = ["--dataset_root", synthetic_root, "--teacher_log_dir", str(teacher),
            "--log_dir", str(tmp_path / "student"), "--device", "cpu",
            "--set", "train.max_epoch=1"]
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        distill_cli.main(args)
    CheckpointManager(str(teacher / "ckpt")).save(create_train_state(cfg.model, cfg.train, "cpu"))
    tr = distill_cli.main(args)
    assert tr.cfg.model.name == "epcnet_l" and tr.state.step > 0
    recs = [json.loads(line) for line in open(tmp_path / "student" / "distill.jsonl")]
    assert {"metric_loss", "mimic_loss"} <= set(recs[0])

