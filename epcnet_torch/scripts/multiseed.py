"""The difficulty-0.5 quality protocol at several train seeds (counterpart of
``scripts/hw_multiseed.py``), and its CI-scale twin.

  python -m epcnet_torch.scripts.multiseed [--root build/multiseed]
      [--seeds 1234,2024,7,42] [--epochs 15] [--teacher_only] [--no_pointnetvlad]
      [--device cpu]

``run`` drives BASELINE.md's protocol through the port's CLIs, calling their
``main(argv)`` in this process:

1. ``generate_tuples --synthetic``: 5 runs x 80 submaps x 4096 points at
   difficulty 0.5, into ``<root>/data``, once;
2. for each seed S, under ``<root>/s<S>``: ``train`` (the default full-width
   ``ModelConfig``, bf16; 15 epochs, lr 2e-4, mining from epoch 5,
   ``train.seed=S``), ``export``, ``evaluate``; then ``distill`` (the
   EPC-Net-L student, 15 epochs, ``train.seed=S``), ``export``,
   ``evaluate``. The port's ``evaluate`` reads the export pair, hence the
   ``export`` steps;
3. the untrained floor: the weights training starts from
   (``init_train_variables(model, 1234)``, ``TrainConfig().seed``), exported
   and evaluated;
4. with ``pointnetvlad``, PointNetVLAD at seed 1234 on the reference recipe
   (one group of 256, lr 5e-5, 15 epochs).

A seed whose ``results.json`` files exist is reused, as in the JAX script
(a half-done seed resumes at the student), so a run may span several
calls. Each step's output goes to ``<root>/<step>.log``. The result,
``<root>/multiseed.json``, has the JAX script's keys (``metric``,
``protocol``, ``seeds``, and ``teacher`` / ``student`` as ``{n, values,
mean, sd}``, recall@1 as a fraction) and adds ``untrained``,
``pointnetvlad``, the paired teacher - student ``gap``, the ``band``
verdicts, the seconds of each step, the peak card memory, whether
``MetricsLogger(tensorboard=True)`` mirrors to TensorBoard here, and the
card's name and power limit.

The band is the JAX package's (BASELINE.md, "Hardware recall table"):
teacher mean recall@1 at least JAX's 92.48% less 5 points; the student mean
within 2 points of the teacher's (``scripts/README.md``); PointNetVLAD above
the untrained floor + 20 points and below the teacher mean. The port's
seeds do not replay JAX's runs (other init streams and kernels): compare
means, not seeds. A result outside the band is reported, not raised.

``ci_run`` is the CI-scale twin (``tests/test_benchmark_quality.py``'s
protocol: 3 runs x 40 submaps x 256 points at difficulty 0.5, a tiny model,
6 epochs), driven through ``Trainer`` and ``evaluate_region``; the bounds
are ``CI_BAND``. ``tests/test_torch_benchmark_quality.py`` runs it on the
CPU and ``chip_smoke.py`` on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import time

import torch

from epcnet_torch.cli import distill, evaluate, export, generate_tuples, train
from epcnet_torch.configs import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from epcnet_torch.data.synthetic import generate_synthetic_dataset
from epcnet_torch.data.tuples import (
    construct_query_and_database_sets,
    construct_query_dict,
    scan_runs,
)
from epcnet_torch.device import resolve_device
from epcnet_torch.evals.recall import evaluate_region
from epcnet_torch.train.trainer import Trainer
from epcnet_torch.utils.logging import MetricsLogger
from epcnet_torch.weights import init_train_variables, save_export

SEEDS = (1234, 2024, 7, 42)
# (runs, submaps a run, points a submap) and the difficulty dial
PROTOCOL_DATA = (5, 80, 4096)
DIFFICULTY = 0.5
TEACHER_SETS = ("train.learning_rate=2e-4", "train.mining_start_epoch=5")
PNV_SEED = 1234
PNV_SETS = ("model.name=pointnetvlad", "model.vlad_groups=1", "model.vlad_group_dim=256",
            "train.learning_rate=5e-5")
# JAX's teacher mean over the same four seeds (hwevidence/r05/multiseed.json)
JAX_TEACHER_MEAN = 0.9248
BAND = {"teacher_floor": JAX_TEACHER_MEAN - 0.05, "student_gap": 0.02,
        "pnv_over_untrained": 0.20}

# the CI-scale twin: tests/test_benchmark_quality.py's data, model, training
# and calibrated bounds (recall@1 as a fraction)
CI_SEEDS = (1234, 7, 2024)
CI_DATA = (3, 40, 256)
CI_BAND = {"untrained_max": 0.32, "trained_min": 0.40, "separation": 0.10,
           "seed_min": 0.35, "spread_max": 0.18}


def _main(fn, argv: list[str], log_path: str) -> float:
    """Run a CLI's ``main(argv)`` with its output in ``log_path``; returns
    its seconds. The card's cached blocks are freed after it."""
    t0 = time.perf_counter()
    with open(log_path, "w") as f, contextlib.redirect_stdout(f):
        print(" ".join(argv), flush=True)
        fn(argv)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return time.perf_counter() - t0


def recall1(log_dir: str) -> float | None:
    """recall@1 of a run's ``results.json``, or None where there is none."""
    path = os.path.join(log_dir, "results.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        res = json.load(f)
    region = res.get("oxford") or next(iter(res.values()))
    return float(region["recall_at"][0])


def _sets(sets) -> list[str]:
    return [a for kv in sets for a in ("--set", kv)]


def _stats(vals: list) -> dict:
    vals = [v for v in vals if v is not None]
    out = {"n": len(vals), "values": vals}
    if len(vals) >= 2:
        out.update(mean=statistics.mean(vals), sd=statistics.stdev(vals))
    elif vals:
        out["mean"] = vals[0]
    return out


def card() -> dict | None:
    """The card's name and power limit as nvidia-smi reports them, or None
    on a machine without one."""
    if not torch.cuda.is_available():
        return None
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.split(","))
    return {"name": name, "power_limit": limit}


def tensorboard_mirrors(tmp: str) -> bool:
    """Whether ``MetricsLogger(tensorboard=True)`` gets a TensorBoard writer
    here, or takes the JSONL fallback."""
    return MetricsLogger(tmp, "tb_probe", tensorboard=True)._tb is not None


def _train_model(fn, argv: list[str], log_dir: str, root: str, name: str, data: str,
                 dev_args) -> dict:
    """Train (``fn`` is ``train.main`` or ``distill.main``), export and
    evaluate one run, each CLI once, logs under ``root``; returns its
    seconds by step."""
    os.makedirs(root, exist_ok=True)
    secs = {name: _main(fn, argv + dev_args, os.path.join(root, f"{name}.log"))}
    secs[f"export_{name}"] = _main(export.main, ["--log_dir", log_dir],
                                   os.path.join(root, f"export_{name}.log"))
    secs[f"eval_{name}"] = _main(
        evaluate.main, ["--dataset_root", data, "--log_dir", log_dir] + dev_args,
        os.path.join(root, f"eval_{name}.log"))
    return secs


def run_seed(seed: int, root: str, data: str, epochs: int, dev_args: list[str],
             teacher_only: bool = False, sets=()) -> dict:
    """One seed of the protocol under ``root``; reuses what is done."""
    log, log_s = os.path.join(root, "log"), os.path.join(root, "log_student")
    row = {"seed": seed, "seconds": {}}
    done_t, done_s = recall1(log), recall1(log_s)
    row["reused"] = done_t is not None and (teacher_only or done_s is not None)
    if done_t is None:
        argv = ["--dataset_root", data, "--log_dir", log,
                *_sets((f"train.max_epoch={epochs}", *TEACHER_SETS, f"train.seed={seed}",
                        *sets))]
        row["seconds"].update(_train_model(train.main, argv, log, root, "teacher", data,
                                           dev_args))
    if not teacher_only and done_s is None:
        argv = ["--dataset_root", data, "--teacher_log_dir", log, "--log_dir", log_s,
                *_sets((f"train.max_epoch={epochs}", f"train.seed={seed}", *sets))]
        row["seconds"].update(_train_model(distill.main, argv, log_s, root, "student", data,
                                           dev_args))
    row["teacher_recall1"], row["student_recall1"] = recall1(log), recall1(log_s)
    print(f"[seed {seed}] teacher {row['teacher_recall1']} student {row['student_recall1']}"
          f"{' (reused)' if row['reused'] else ''}; seconds {row['seconds']}", flush=True)
    return row


def run(root: str = os.path.join("build", "multiseed"), seeds=SEEDS, epochs: int = 15,
        device=None, teacher_only: bool = False, pointnetvlad: bool = True,
        sets=(), data_shape=PROTOCOL_DATA) -> dict:
    """The protocol at ``seeds``; writes and returns ``<root>/multiseed.json``.
    ``sets`` (``section.field=value``) apply to every model trained and to
    the untrained floor's model, and ``data_shape`` is (runs, submaps,
    points): both only to run it small (the tests), and both are written
    into ``protocol`` and the JSON, so a run off the protocol says so."""
    dev = resolve_device(device)  # no card, no run
    dev_args = ["--device", dev.type]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    data = os.path.join(root, "data")
    os.makedirs(root, exist_ok=True)
    secs = {}
    if not os.path.isfile(os.path.join(data, "training_queries_baseline.pickle")):
        runs, per_run, npts = data_shape
        secs["generate_tuples"] = _main(generate_tuples.main, [
            "--dataset_root", data, "--synthetic", "--synthetic_runs", str(runs),
            "--synthetic_submaps", str(per_run), "--num_points", str(npts),
            "--synthetic_difficulty", str(DIFFICULTY)], os.path.join(root, "generate.log"))

    rows = [run_seed(s, os.path.join(root, f"s{s}"), data, epochs, dev_args,
                     teacher_only=teacher_only, sets=sets) for s in seeds]

    floor_dir = os.path.join(root, "untrained")
    if recall1(floor_dir) is None:
        cfg = train.load_config(None, data, floor_dir, list(sets))
        save_export(os.path.join(floor_dir, "export"), cfg,
                    init_train_variables(cfg.model, TrainConfig().seed))
        secs["eval_untrained"] = _main(
            evaluate.main, ["--dataset_root", data, "--log_dir", floor_dir] + dev_args,
            os.path.join(root, "eval_untrained.log"))
    untrained = recall1(floor_dir)

    pnv = None
    if pointnetvlad:
        pnv_dir = os.path.join(root, "pnv", "log")
        if recall1(pnv_dir) is None:
            argv = ["--dataset_root", data, "--log_dir", pnv_dir,
                    *_sets((f"train.max_epoch={epochs}", f"train.seed={PNV_SEED}", *PNV_SETS,
                            *sets))]
            secs.update({f"pnv_{k}": v for k, v in _train_model(
                train.main, argv, pnv_dir, os.path.join(root, "pnv"), "pointnetvlad", data,
                dev_args).items()})
        pnv = {"seed": PNV_SEED, "recall1": recall1(pnv_dir)}

    teacher = _stats([r["teacher_recall1"] for r in rows])
    student = _stats([r["student_recall1"] for r in rows])
    gap = _stats([r["teacher_recall1"] - r["student_recall1"] for r in rows
                  if r["teacher_recall1"] is not None and r["student_recall1"] is not None])
    band = {**BAND, "teacher_ok": teacher.get("mean", -1.0) >= BAND["teacher_floor"]}
    if student["n"]:
        band["student_ok"] = abs(teacher["mean"] - student["mean"]) <= BAND["student_gap"]
    if pnv is not None and pnv["recall1"] is not None and untrained is not None:
        band["pnv_ok"] = (untrained + BAND["pnv_over_untrained"] < pnv["recall1"]
                          < teacher.get("mean", -1.0))
    runs, per_run, npts = data_shape
    out = {
        "metric": "multiseed_quality",
        "protocol": f"{runs}x{per_run}x{npts} difficulty {DIFFICULTY}, {epochs} epochs, "
                    "mining from epoch 5 (scripts/README.md), port CLIs"
                    + (f", --set {' '.join(sets)}" if sets else ""),
        "epochs": epochs,
        "data_shape": list(data_shape),
        "sets": list(sets),
        "seeds": rows,
        "teacher": teacher,
        "student": student,
        "gap": gap,
        "untrained": {"seed": TrainConfig().seed, "recall1": untrained},
        "pointnetvlad": pnv,
        "band": band,
        "seconds": secs,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                              else None),
        "tensorboard_mirrors": tensorboard_mirrors(os.path.join(root, "tb_probe")),
        "device": card() if dev.type == "cuda" else None,
    }
    path = os.path.join(root, "multiseed.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


# -- the CI-scale twin ------------------------------------------------------

def ci_dataset(root: str) -> str:
    runs, per_run, npts = CI_DATA
    generate_synthetic_dataset(root, num_runs=runs, submaps_per_run=per_run,
                               num_points=npts, difficulty=DIFFICULTY)
    return root


def ci_config(root: str, seed: int, log_dir: str) -> ExperimentConfig:
    """``tests/test_benchmark_quality.py``'s model, data and training."""
    npts = CI_DATA[2]
    model = ModelConfig(
        num_points=npts, knn_k=8, use_pallas=False,
        proxyconv_channels=(16, 16), lift_channels=(32, 64), feature_dim=64,
        vlad_clusters=8, vlad_groups=4, vlad_group_dim=16,
    )
    return ExperimentConfig(
        model=model,
        data=DataConfig(dataset_root=root, num_points=npts, num_negatives=6, num_positives=2),
        train=TrainConfig(batch_num_queries=8, max_epoch=6, learning_rate=1e-3,
                          mining_start_epoch=3, mining_refresh_steps=200,
                          log_every_steps=1000, checkpoint_every_steps=10**6, seed=seed),
        log_dir=log_dir,
    )


def ci_run(root: str, seed: int, log_dir: str, device=None, untrained: bool = False) -> dict:
    """Train the CI-scale protocol at ``seed`` on ``device`` and evaluate it:
    ``{"trained": recall@1, "untrained": recall@1 before training (with
    ``untrained``, else None), "loss": every step's loss, "epoch_ends": the
    step count at each epoch's end}``."""
    df = scan_runs(root)
    tt = construct_query_dict(df, exclude_test_regions=False)
    db_sets, q_sets = construct_query_and_database_sets(df, 25.0, only_test_regions=False)
    cfg = ci_config(root, seed, log_dir)
    trainer = Trainer(cfg, tt, checkpoints=False, device=device)

    def recall() -> float:
        res = evaluate_region(trainer.embed_fn, db_sets, q_sets, cfg.data, cfg.eval)
        return float(res["recall_at"][0])

    out = {"untrained": recall() if untrained else None}
    losses, ends = [], []
    step_fn = trainer.step_fn

    def recorded(state, batch):  # the step itself, its loss kept
        state, m = step_fn(state, batch)
        losses.append(m["loss"].detach())
        return state, m

    trainer.step_fn = recorded
    trainer.train(on_epoch_end=lambda tr, epoch: ends.append(len(losses)))
    out.update(trained=recall(), loss=[float(v) for v in losses], epoch_ends=ends)
    return out


def ci_band_failures(untrained: float, trained: float, recalls: dict) -> list[str]:
    """The CI band's assertions, as ``tests/test_benchmark_quality.py`` makes
    them: on one seed's recall@1 before and after training, and on the
    trained recall@1 by seed. Returns the ones that fail."""
    b, bad = CI_BAND, []
    if untrained > b["untrained_max"]:
        bad.append(f"untrained recall@1 {untrained:.3f} above {b['untrained_max']}")
    if trained < b["trained_min"] or trained >= 1.0:
        bad.append(f"trained recall@1 {trained:.3f} outside [{b['trained_min']}, 1)")
    if trained - untrained < b["separation"]:
        bad.append(f"trained {trained:.3f} within {b['separation']} of untrained "
                   f"{untrained:.3f}")
    vals = sorted(recalls.values())
    if any(v < b["seed_min"] for v in vals):
        bad.append(f"a seed fell below {b['seed_min']}: {recalls}")
    if vals[-1] - vals[0] > b["spread_max"]:
        bad.append(f"seed spread {vals[-1] - vals[0]:.3f} above {b['spread_max']}: {recalls}")
    return bad


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join("build", "multiseed"))
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--teacher_only", action="store_true")
    ap.add_argument("--no_pointnetvlad", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.root, [int(s) for s in args.seeds.split(",") if s], args.epochs,
               args.device, args.teacher_only, not args.no_pointnetvlad)


if __name__ == "__main__":
    main()
