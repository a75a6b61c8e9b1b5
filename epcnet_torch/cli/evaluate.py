"""Evaluation CLI (twin of ``epcnet_tpu/cli/evaluate.py``): embeds every
region's database and query runs and writes the recall table to
``results.txt`` in the reference's format, with a ``results.json`` twin.

  python -m epcnet_torch.cli.evaluate --dataset_root D --log_dir log
      [--regions oxford university ...] [--latency_probe] [--quantize int8]
      [--database_pickle db.pickle --query_pickle q.pickle] [--device cpu]

Weights and config come from the ``<log_dir>/export`` pair
(``python -m epcnet_tpu.cli.export`` or ``weights.save_export``), not from
an Orbax checkpoint; ``--config`` replaces the pair's config, and
``--dataset_root`` and ``--set`` apply on top. The model runs on the card
unless ``--device cpu`` is given. ``--mesh`` is ROADMAP item 6; the JAX
CLI's ``--compilation_cache_dir`` has no counterpart (eager PyTorch compiles
nothing per shape; the kernels' builds are cached under
``epcnet_torch/csrc/build``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from epcnet_torch.configs import ExperimentConfig, apply_overrides
from epcnet_torch.data.tuples import (
    any_in_test_regions,
    construct_query_and_database_sets,
    load_pickle,
    scan_runs,
)
from epcnet_torch.device import resolve_device
from epcnet_torch.evals import embed_entries, evaluate_dataset, retrieval_latency_probe
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.utils.logging import log_string
from epcnet_torch.weights import load_export

_MESH = "--mesh (sharded retrieval) is not ported yet (ROADMAP item 6, Multi-device)"


def load_run(log_dir: str, config: str | None, overrides, device: str | None):
    """(config, embed) of the export pair in ``log_dir``, on ``device``:
    the pair's config, replaced by the file ``config`` if one is given,
    then ``overrides`` (``section.field=value``) on top."""
    dev = resolve_device(device)  # before any work: no card, no run
    base = os.path.join(log_dir, "export")
    cfg, flat = load_export(base)
    if config:
        with open(config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    embed = build_embed_fn(cfg.model, dev, variables=flat)
    log_string(f"loaded {base}.npz ({cfg.model.name}, {len(flat)} arrays) on {dev}")
    return cfg, embed


def write_results(results: dict, out_path: str) -> None:
    """results.txt in the reference's format, and its .json twin."""
    with open(out_path, "w") as f:
        for name, m in results.items():
            f.write(f"== {name} ==\n")
            f.write("Average Recall @N:\n")
            f.write(str(np.round(100 * m["recall_at"], 2)) + "\n")
            f.write(f"Average Top 1% Recall: {100 * m['recall_at_1pct']:.2f}\n\n")
    with open(os.path.splitext(out_path)[0] + ".json", "w") as f:
        json.dump({name: {"recall_at": [float(x) for x in m["recall_at"]],
                          "recall_at_1pct": float(m["recall_at_1pct"])}
                   for name, m in results.items()}, f, indent=1)


def main(argv=None) -> dict:
    """Returns {"results": evaluate_dataset's dict, "latency": the probe's
    dict or None}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", default=[], dest="overrides")
    ap.add_argument("--dataset_root", default=None)
    ap.add_argument("--log_dir", default="log")
    ap.add_argument("--regions", nargs="*", default=None,
                    help="region subdirs to evaluate; default: data.runs_subdir")
    ap.add_argument("--database_pickle", default=None)
    ap.add_argument("--query_pickle", default=None)
    ap.add_argument("--mesh", action="store_true", help="shard the DB over devices")
    ap.add_argument("--quantize", default="none", choices=("none", "int8"),
                    help="retrieve against the int8-quantized DB (the "
                    "serving capacity format) to quantify its recall cost")
    ap.add_argument("--latency_probe", action="store_true")
    ap.add_argument("--output", default=None, help="default <log_dir>/results.txt")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if bool(args.database_pickle) != bool(args.query_pickle):
        ap.error("--database_pickle and --query_pickle must be given together")
    if args.mesh:
        raise NotImplementedError(_MESH)

    overrides = ([f"data.dataset_root={args.dataset_root}"] if args.dataset_root else []
                 ) + args.overrides
    cfg, embed = load_run(args.log_dir, args.config, overrides, args.device)

    regions = {}
    if args.database_pickle:
        regions["pickled"] = (load_pickle(args.database_pickle),
                              load_pickle(args.query_pickle))
    else:
        for name in args.regions or [cfg.data.runs_subdir]:
            table = scan_runs(cfg.data.dataset_root, name)
            # real-Oxford queries are restricted to the held-out rectangles
            # (found by UTM, not by directory name); the database always
            # keeps full runs
            regions[name] = construct_query_and_database_sets(
                table, cfg.data.test_positive_radius_m,
                only_test_regions=any_in_test_regions(table),
            )

    results = evaluate_dataset(embed, regions, cfg.data, cfg.eval, quantize=args.quantize)
    out_path = args.output or os.path.join(args.log_dir, "results.txt")
    write_results(results, out_path)
    avg = results["average"]
    log_string(
        f"avg recall@1={100 * avg['recall_at'][0]:.2f}% "
        f"@1%={100 * avg['recall_at_1pct']:.2f}% -> {out_path}"
    )

    lat = None
    if args.latency_probe:
        name = next(iter(regions))
        db_desc = embed_entries(embed, regions[name][0][0], cfg.data, cfg.eval.batch_size)
        lat = retrieval_latency_probe(db_desc, cfg.eval.latency_probe_queries,
                                      cfg.eval.top_k, device=embed.device)
        log_string(
            f"retrieval latency p50={lat['p50_ms']:.3f}ms "
            f"p99={lat['p99_ms']:.3f}ms "
            f"device={lat['device_ms']:.3f}ms (dispatch-free)"
        )
    return {"results": results, "latency": lat}


if __name__ == "__main__":
    main()
