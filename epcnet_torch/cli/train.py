"""Training CLI (twin of ``epcnet_tpu/cli/train.py``).

  python -m epcnet_torch.cli.train --dataset_root D [--config cfg.json]
      [--set train.learning_rate=1e-4 --set model.knn_k=20 ...]
      [--tuples_pickle P] [--log_dir log] [--restore] [--synthetic]
      [--profile_dir dir] [--eval_every_epochs N] [--mesh] [--device cpu]
      [--compilation_cache_dir D]

Writes ``<log_dir>/config.json``, ``<log_dir>/train.jsonl`` and the port's
checkpoints under ``<log_dir>/ckpt`` (``train/checkpoint.py``);
``python -m epcnet_torch.cli.export`` turns the latest into the export pair
the port's (and the JAX package's) evaluation reads. Runs on the card
unless ``--device cpu`` is given. ``--mesh`` trains data-parallel over the
ranks of a process group (one process a rank, set up from the
``EPCNET_*`` variables by ``parallel.maybe_initialize_distributed``: NCCL
on the cards, gloo with ``--device cpu``; without them a world of one),
BatchNorm over the global batch; rank 0 logs and writes.
``--compilation_cache_dir`` (else ``$EPCNET_COMPILATION_CACHE_DIR``) is
where the CUDA kernels are built and found again (``utils/compile_cache.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

from epcnet_torch.configs import ExperimentConfig, apply_overrides
from epcnet_torch.data.synthetic import generate_synthetic_dataset
from epcnet_torch.data.tuples import TrainingTuples, construct_query_dict, load_pickle, scan_runs
from epcnet_torch.device import resolve_device
from epcnet_torch.evals.hooks import make_recall_eval_hook
from epcnet_torch.parallel import PreemptionGuard, ProcessMesh, maybe_initialize_distributed
from epcnet_torch.parallel.collectives import barrier
from epcnet_torch.parallel.mesh import is_primary
from epcnet_torch.train.trainer import Trainer
from epcnet_torch.utils.compile_cache import add_cli_arg, enable_compilation_cache
from epcnet_torch.utils.logging import log_string
from epcnet_torch.utils.profiling import start_trace

def load_config(path: str | None, dataset_root: str | None, log_dir: str | None,
                overrides) -> ExperimentConfig:
    """The experiment config: the file ``path`` (else the defaults), then
    ``--dataset_root``, ``--log_dir`` and the ``--set`` overrides on top."""
    cfg = ExperimentConfig()
    if path:
        with open(path) as f:
            cfg = ExperimentConfig.from_json(f.read())
    if dataset_root:
        cfg = apply_overrides(cfg, [f"data.dataset_root={dataset_root}"])
    if log_dir:
        cfg = dataclasses.replace(cfg, log_dir=log_dir)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def training_tuples(cfg: ExperimentConfig, tuples_pickle: str | None, synthetic: bool):
    """(tuples, runs table or None): from the pickle, else built from the
    dataset's runs (test regions excluded unless the data is synthetic)."""
    if tuples_pickle:
        return TrainingTuples(load_pickle(tuples_pickle)), None
    df = scan_runs(cfg.data.dataset_root, cfg.data.runs_subdir)
    return construct_query_dict(df, cfg.data.positive_radius_m, cfg.data.negative_radius_m,
                                exclude_test_regions=not synthetic), df


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="ExperimentConfig JSON file")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override section.field=value (repeatable)")
    ap.add_argument("--dataset_root", default=None)
    ap.add_argument("--tuples_pickle", default=None,
                    help="pre-generated training pickle; else tuples are built")
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("--restore", action="store_true",
                    help="resume from the latest checkpoint in log_dir")
    ap.add_argument("--mesh", action="store_true", help="data-parallel over devices")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace of the run there")
    ap.add_argument("--eval_every_epochs", type=int, default=0,
                    help="evaluate recall@1 on the dataset's test sets every N epochs and "
                    "keep the BEST checkpoint in <log_dir>/ckpt_best; 0 = off")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    add_cli_arg(ap)
    args = ap.parse_args(argv)
    enable_compilation_cache(args.compilation_cache_dir)
    # the process group first, before any CUDA work (a no-op when nothing is set)
    maybe_initialize_distributed(device=args.device)
    device = resolve_device(args.device)  # before any work: no card, no run

    cfg = load_config(args.config, args.dataset_root, args.log_dir, args.overrides)
    mesh = ProcessMesh(cfg.mesh) if args.mesh else None
    if args.synthetic and is_primary():
        generate_synthetic_dataset(cfg.data.dataset_root, num_points=cfg.data.num_points,
                                   runs_subdir=cfg.data.runs_subdir)
    if mesh is not None:
        barrier(mesh.world)  # rank 0's dataset in place
    tuples, df = training_tuples(cfg, args.tuples_pickle, args.synthetic)
    log_string(f"{len(tuples.queries)} training tuples; device {device}"
               + (f"; mesh {mesh.shape}" if mesh is not None else ""))
    if is_primary():
        os.makedirs(cfg.log_dir, exist_ok=True)
        with open(os.path.join(cfg.log_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    trainer = Trainer(cfg, tuples, mesh=mesh, device=device)
    if args.restore:
        log_string(f"restored at step {trainer.maybe_restore()}")
    on_epoch_end, finalize_eval = make_recall_eval_hook(
        cfg, args.eval_every_epochs, df=df, resumed=args.restore)
    trace = start_trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    with trace, PreemptionGuard() as guard:
        trainer.train(on_epoch_end=on_epoch_end, should_stop=guard)
    finalize_eval()
    return trainer


if __name__ == "__main__":
    main()
