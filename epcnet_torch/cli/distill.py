"""EPC-Net-L distillation CLI [PAPER §III-D] (twin of
``epcnet_tpu/cli/distill.py``).

Trains the slim student against a frozen EPC-Net teacher with metric loss +
feature-mimic MSE (``train/step.py::build_distill_step``), driven by the
same Trainer as ``cli/train.py``: resume, preemption safety, mining and
JSONL metrics.

  python -m epcnet_torch.cli.distill --dataset_root D --teacher_log_dir log \\
      [--alpha 1.0] [--log_dir log_student] [--restore] [--mesh] [--synthetic]
      [--device cpu] [--compilation_cache_dir D]

The teacher's weights come from its export pair ``<teacher_log_dir>/export``
(written by either package's ``cli/export.py``) when there is one, else from
the latest port checkpoint under ``<teacher_log_dir>/ckpt`` (required).
``--mesh``: data-parallel over a process group, as ``cli/train.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from epcnet_torch.configs import ExperimentConfig, apply_overrides, epcnet_l_config
from epcnet_torch.data.synthetic import generate_synthetic_dataset
from epcnet_torch.data.tuples import construct_query_dict, scan_runs
from epcnet_torch.device import resolve_device
from epcnet_torch.evals.hooks import make_recall_eval_hook
from epcnet_torch.models import get_model
from epcnet_torch.parallel import PreemptionGuard, ProcessMesh, maybe_initialize_distributed
from epcnet_torch.parallel.collectives import barrier
from epcnet_torch.parallel.mesh import is_primary
from epcnet_torch.train.checkpoint import read_run_config, restore_model
from epcnet_torch.train.step import build_distill_step
from epcnet_torch.train.trainer import Trainer
from epcnet_torch.utils.compile_cache import add_cli_arg, enable_compilation_cache
from epcnet_torch.utils.logging import log_string
from epcnet_torch.weights import load_export, load_flat_variables

def load_teacher(teacher_log_dir: str, device):
    """(teacher experiment config, teacher model on ``device``): from the
    export pair if the run has one, else from its latest checkpoint."""
    base = os.path.join(teacher_log_dir, "export")
    if os.path.isfile(base + ".npz"):
        exp, flat = load_export(base)
        model = get_model(exp.model, device)
        load_flat_variables(model, flat)
        log_string(f"teacher from {base}.npz")
        return exp, model
    exp = read_run_config(teacher_log_dir)
    model, step = restore_model(teacher_log_dir, exp, device)
    log_string(f"teacher restored at step {step}")
    return exp, model


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--teacher_log_dir", required=True)
    ap.add_argument("--log_dir", default="log_student")
    ap.add_argument("--alpha", type=float, default=1.0, help="mimic-loss weight")
    ap.add_argument("--set", action="append", default=[], dest="overrides")
    ap.add_argument("--restore", action="store_true",
                    help="resume the student from the latest checkpoint in log_dir")
    ap.add_argument("--eval_every_epochs", type=int, default=0,
                    help="evaluate student recall@1 every N epochs, keeping the best "
                    "checkpoint in <log_dir>/ckpt_best; 0 = off")
    ap.add_argument("--mesh", action="store_true", help="data-parallel over devices")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    add_cli_arg(ap)
    args = ap.parse_args(argv)
    enable_compilation_cache(args.compilation_cache_dir)
    maybe_initialize_distributed(device=args.device)  # before any CUDA work
    device = resolve_device(args.device)

    teacher_exp, teacher = load_teacher(args.teacher_log_dir, device)
    tcfg = teacher_exp.model
    student_cfg = epcnet_l_config(num_points=tcfg.num_points, knn_k=tcfg.knn_k,
                                  use_pallas=tcfg.use_pallas, output_dim=tcfg.output_dim)
    # the TEACHER's data plane (runs_subdir, radii, tuple shape,
    # augmentation); only the root changes
    cfg = ExperimentConfig(
        model=student_cfg,
        data=dataclasses.replace(teacher_exp.data, dataset_root=args.dataset_root),
        train=teacher_exp.train, log_dir=args.log_dir)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    mesh = ProcessMesh(cfg.mesh) if args.mesh else None
    if args.synthetic and is_primary() and not os.path.isdir(
            os.path.join(cfg.data.dataset_root, cfg.data.runs_subdir)):
        generate_synthetic_dataset(cfg.data.dataset_root, num_points=cfg.data.num_points,
                                   runs_subdir=cfg.data.runs_subdir)
    if mesh is not None:
        barrier(mesh.world)
    df = scan_runs(cfg.data.dataset_root, cfg.data.runs_subdir)
    tuples = construct_query_dict(df, cfg.data.positive_radius_m, cfg.data.negative_radius_m,
                                  exclude_test_regions=not args.synthetic)
    distill_step = build_distill_step(cfg.model, tcfg, cfg.train, args.alpha,
                                      None if mesh is None else mesh.group("data"))
    if is_primary():
        os.makedirs(cfg.log_dir, exist_ok=True)
        with open(os.path.join(cfg.log_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    trainer = Trainer(cfg, tuples, mesh=mesh, metrics_name="distill", device=device,
                      step_fn=lambda state, batch: distill_step(state, teacher, batch))
    if args.restore:
        log_string(f"student restored at step {trainer.maybe_restore()}")
    on_epoch_end, finalize_eval = make_recall_eval_hook(
        cfg, args.eval_every_epochs, df=df, resumed=args.restore)
    with PreemptionGuard() as guard:
        trainer.train(on_epoch_end=on_epoch_end, should_stop=guard)
    finalize_eval()
    return trainer


if __name__ == "__main__":
    main()
