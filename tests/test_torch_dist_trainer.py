"""The port's ``Trainer`` with ``mesh=`` over 2 gloo ranks on the CPU
(``tests/test_multidevice.py::test_trainer_with_mesh`` and
``tests/test_multiprocess.py``, ported): data-parallel epochs with a mining
sweep split over the ranks, rank 0 alone writing checkpoints and metrics,
and an exact resume. The preemption run (SIGTERM to rank 0 alone, the
ranks agreeing to stop, then ``--restore``) is ``slow``, as JAX's
multi-process tests are.

Bounds: a resume is exact to 1e-7 (``tests/test_train.py:144``); the ranks
hold identical parameters and latents (no tolerance).
"""

import json
import os

import numpy as np
import pytest

from epcnet_torch.data.synthetic import generate_synthetic_dataset
from torch_dist_worker import spawn

RESUME_ATOL = 1e-7


def _workdir(tmp_path_factory, name):
    wd = tmp_path_factory.mktemp(name)
    generate_synthetic_dataset(str(wd / "data"), num_runs=3, submaps_per_run=30,
                               num_points=128)
    return wd


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    wd = _workdir(tmp_path_factory, "dist_trainer")
    return wd, spawn("trainer", 2, str(wd), timeout=300)


def test_ranks_hold_identical_parameters_and_latents(run):
    _, (o0, o1) = run
    assert o0["latents"].shape[0] == 90 and np.isfinite(o0["latents"]).all()
    for key, v in o0.items():
        np.testing.assert_array_equal(o1[key], v, err_msg=key)


def test_rank0_writes_one_checkpoint_and_the_metrics(run):
    wd, (o0, _) = run
    assert int(o0["ckpt_files_after_1"]) == 1
    recs = [json.loads(line) for line in open(wd / "run" / "train.jsonl")]
    # one writer: every line whole, steps increasing, no duplicates
    steps = [r["step"] for r in recs]
    assert steps == sorted(set(steps)) and all(np.isfinite(r["loss"]) for r in recs)
    # epoch 1's checkpoint beside epoch 0's, and no half-written file
    assert sorted(os.listdir(wd / "run" / "ckpt")) == [f"step_{int(o0['restored_step'])}.pt",
                                                       f"step_{int(o0['step'])}.pt"]


def test_resume_is_exact(run):
    _, (o0, _) = run
    assert 0 < int(o0["restored_step"]) < int(o0["step"])
    for key in o0:
        if key.startswith("straight/"):
            np.testing.assert_allclose(o0[key.replace("straight/", "resumed/")], o0[key],
                                       atol=RESUME_ATOL, rtol=0, err_msg=key)


@pytest.mark.slow
def test_sigterm_consensus_and_resume(tmp_path_factory):
    """SIGTERM reaches rank 0 alone once metrics appear; both ranks stop at
    the same dispatch (the MAX of their flags every 8 dispatches), rank 0
    checkpoints and both exit 0; a respawned group restores and ends where
    an uninterrupted run ends."""
    wd = _workdir(tmp_path_factory, "dist_preempt")
    cut = spawn("preempt", 2, str(wd), timeout=300, extra=("--log", "cut"),
                signal_rank0_when=str(wd / "cut" / "train.jsonl"))
    assert int(cut[0]["step"]) == int(cut[1]["step"])
    assert os.listdir(wd / "cut" / "ckpt") == [f"step_{int(cut[0]['step'])}.pt"]
    done = spawn("preempt", 2, str(wd), timeout=300, extra=("--log", "cut", "--restore"))
    whole = spawn("preempt", 2, str(wd), timeout=300, extra=("--log", "whole"))
    assert int(cut[0]["step"]) < int(done[0]["step"]) == int(whole[0]["step"])
    for key in whole[0]:
        np.testing.assert_allclose(done[0][key], whole[0][key], atol=RESUME_ATOL, rtol=0,
                                   err_msg=key)
