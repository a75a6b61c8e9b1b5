"""Trainer epoch hooks built on the eval stack (twin of
``epcnet_tpu/evals/hooks.py``).

``make_recall_eval_hook`` gives a Trainer-driven CLI (train, distill)
recall@1 evaluation during training and best-checkpoint retention: every N
epochs, embed the dataset's test sets with the current weights, log
recall@1, and keep the best-scoring checkpoint in ``<log_dir>/ckpt_best``.
"""

from __future__ import annotations

import json
import os
import shutil

from epcnet_torch.data.tuples import (
    any_in_test_regions,
    construct_query_and_database_sets,
    scan_runs,
)
from epcnet_torch.evals.recall import evaluate_region
from epcnet_torch.parallel.mesh import is_primary
from epcnet_torch.train.checkpoint import CheckpointManager
from epcnet_torch.utils.logging import log_string

def make_recall_eval_hook(cfg, every_epochs: int, df=None, resumed=False):
    """Build (on_epoch_end, finalize) for ``Trainer.train``.

    ``on_epoch_end(trainer, epoch)`` evaluates every ``every_epochs`` epochs
    and keeps the best checkpoint; ``finalize()`` waits for its save.
    Returns ``(None, no-op)`` when ``every_epochs`` <= 0.

    The best score persists in ``<log_dir>/best_recall.json``, so a resumed
    run (``resumed=True``, i.e. --restore) cannot overwrite ``ckpt_best``
    with a worse checkpoint; a fresh run in a reused log_dir retires the
    previous run's best, score and checkpoint both. ``df``: the scanned runs
    table, to skip a second walk of the dataset. In a multi-process run
    every rank evaluates (the same weights, the same score) and rank 0
    alone writes the files."""
    if every_epochs <= 0:
        return None, (lambda: None)
    if df is None:
        df = scan_runs(cfg.data.dataset_root, cfg.data.runs_subdir)
    db_sets, q_sets = construct_query_and_database_sets(
        df, cfg.data.test_positive_radius_m, only_test_regions=any_in_test_regions(df))
    best_dir = os.path.join(cfg.log_dir, "ckpt_best")
    best_path = os.path.join(cfg.log_dir, "best_recall.json")
    best = {"recall": -1.0}
    if resumed:
        if os.path.isfile(best_path):
            with open(best_path) as f:
                best["recall"] = float(json.load(f)["recall_at_1"])
            log_string(f"best-recall retention resumes at {100 * best['recall']:.2f}%")
    elif is_primary():
        if os.path.isfile(best_path):
            os.remove(best_path)
        shutil.rmtree(best_dir, ignore_errors=True)
    best_mgr = CheckpointManager(best_dir, keep=1)

    def on_epoch_end(tr, epoch):
        if (epoch + 1) % every_epochs:
            return
        m = evaluate_region(tr.embed_fn, db_sets, q_sets, cfg.data, cfg.eval)
        r1 = float(m["recall_at"][0])
        tr.metrics.write(tr.state.step, {"eval_recall_at_1": r1}, epoch=epoch)
        log_string(f"epoch {epoch}: eval recall@1={100 * r1:.2f}%")
        if r1 > best["recall"]:
            best["recall"] = r1
            tr.save_checkpoint(best_mgr)
            if tr.primary:
                with open(best_path, "w") as f:
                    json.dump({"recall_at_1": r1, "step": tr.state.step}, f)
            log_string(f"new best recall@1 -> {cfg.log_dir}/ckpt_best")

    return on_epoch_end, best_mgr.wait
