"""Descriptor-extraction CLI (twin of ``epcnet_tpu/cli/embed.py``): point-
cloud files in, global descriptors out.

  python -m epcnet_torch.cli.embed --log_dir log --output descs.npy \\
      cloud0.bin cloud1.npy ... [--batch_size 32] [--dataset_root R] [--device cpu]

Inputs (by extension): ``.bin``, raw float64 xyz with N taken from the file
size; ``.npy``, a float array [N, 3]. Every cloud must have exactly
``model.num_points`` points; the batched forward pads the last batch.
``--points_sharded`` (a cloud's points over several cards, with its
``--pad_multiple``) is ROADMAP item 6. Weights and config come from the
``<log_dir>/export`` pair, as in ``cli/evaluate.py``; the model runs on
the card unless ``--device cpu``.

Output: ``<output>.npy`` [num_clouds, output_dim] fp32 L2-normalised rows
in input order, and ``<output>.json``, a manifest of row -> source file.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from epcnet_torch.cli.evaluate import load_run
from epcnet_torch.data.pointclouds import load_pc_file
from epcnet_torch.utils.logging import log_string

_POINTS_SHARDED = ("--points_sharded (a cloud's points over several cards) is not "
                   "ported yet (ROADMAP item 6, Multi-device)")


def load_cloud(path: str, dataset_root: str = "") -> np.ndarray:
    """One cloud file -> [N, 3] float32. N is read, not assumed."""
    if path.endswith(".npy"):
        full = os.path.join(dataset_root, path) if dataset_root else path
        pc = np.load(full)
        if pc.ndim != 2 or pc.shape[1] != 3:
            raise ValueError(f"{full}: expected [N, 3] array, got {pc.shape}")
        return np.asarray(pc, np.float32)
    return load_pc_file(path, dataset_root, num_points=None)


def main(argv=None) -> np.ndarray:
    """Returns the descriptors it saved."""
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="+", help=".bin (fp64 xyz) or .npy [N,3] files")
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", default=[], dest="overrides")
    ap.add_argument("--dataset_root", default="")
    ap.add_argument("--log_dir", default="log")
    ap.add_argument("--output", default="descriptors.npy")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument(
        "--points_sharded", action="store_true",
        help="shard each cloud's point axis over all devices "
             "(no num_points cap; sizes may vary)",
    )
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.points_sharded:
        raise NotImplementedError(_POINTS_SHARDED)

    cfg, embed = load_run(args.log_dir, args.config, args.overrides, args.device)
    clouds = [load_cloud(p, args.dataset_root) for p in args.inputs]
    out = np.stack(_embed_batched(embed, clouds, cfg, args.batch_size), axis=0)
    np.save(args.output, out)
    base = args.output[:-4] if args.output.endswith(".npy") else args.output
    with open(base + ".json", "w") as f:
        json.dump({"files": list(args.inputs), "shape": list(out.shape)}, f, indent=1)
    log_string(f"embedded {out.shape[0]} clouds -> {args.output} {out.shape}")
    return out


def _embed_batched(embed, clouds, cfg, batch_size):
    """Every cloud is exactly model.num_points; fixed batches, the last one
    zero-padded."""
    npts = cfg.model.num_points
    for i, c in enumerate(clouds):
        if c.shape[0] != npts:
            raise ValueError(
                f"input {i} has {c.shape[0]} points but model.num_points={npts}; "
                f"use --points_sharded for arbitrary sizes"
            )
    descs = []
    buf = np.zeros((batch_size, npts, 3), np.float32)
    for s in range(0, len(clouds), batch_size):
        cnt = min(s + batch_size, len(clouds)) - s
        buf[:cnt] = np.stack(clouds[s:s + cnt])
        if cnt < batch_size:
            buf[cnt:] = 0.0
        descs.extend(embed(buf)[:cnt].cpu().numpy())
    return descs


if __name__ == "__main__":
    main()
