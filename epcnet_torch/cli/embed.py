"""Descriptor-extraction CLI (twin of ``epcnet_tpu/cli/embed.py``): point-
cloud files in, global descriptors out.

  python -m epcnet_torch.cli.embed --log_dir log --output descs.npy \\
      cloud0.bin cloud1.npy ... [--batch_size 32] [--dataset_root R]
      [--points_sharded [--pad_multiple 512]] [--device cpu]
      [--compilation_cache_dir D]

Inputs (by extension): ``.bin``, raw float64 xyz with N taken from the file
size; ``.npy``, a float array [N, 3]. Every cloud must have exactly
``model.num_points`` points; the batched forward pads the last batch.
``--points_sharded`` embeds clouds of any size one at a time, each cloud's
point axis sharded over the ranks of a process group
(``models/points_sharded.py``; one process a rank, set up from the
``EPCNET_*`` variables; without them a world of one), N padded to a
multiple of ``--pad_multiple`` x the ranks; rank 0 writes the output.
Weights and config come from the
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
import torch.distributed as dist

from epcnet_torch.cli.evaluate import load_run
from epcnet_torch.configs import MeshConfig
from epcnet_torch.data.pointclouds import load_pc_file
from epcnet_torch.models.points_sharded import embed_points_sharded
from epcnet_torch.parallel import ProcessMesh, maybe_initialize_distributed
from epcnet_torch.parallel.mesh import is_primary
from epcnet_torch.utils.compile_cache import add_cli_arg, enable_compilation_cache
from epcnet_torch.utils.logging import log_string
from epcnet_torch.weights import flat_variables


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
        help="shard each cloud's point axis over the ranks of the process group "
             "(no num_points cap; sizes may vary)",
    )
    ap.add_argument("--pad_multiple", type=int, default=512,
                    help="points-sharded: pad each cloud to a multiple of this (per rank)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    add_cli_arg(ap)
    args = ap.parse_args(argv)
    enable_compilation_cache(args.compilation_cache_dir)
    if args.points_sharded:
        maybe_initialize_distributed(device=args.device)  # before any CUDA work

    cfg, embed = load_run(args.log_dir, args.config, args.overrides, args.device)
    clouds = [load_cloud(p, args.dataset_root) for p in args.inputs]
    if args.points_sharded:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = ProcessMesh(MeshConfig(data_axis=1, db_axis=world))
        flat = flat_variables(embed.model)
        descs = [embed_points_sharded(flat, c, cfg.model, mesh, npad_multiple=args.pad_multiple,
                                      device=embed.device).cpu().numpy() for c in clouds]
    else:
        descs = _embed_batched(embed, clouds, cfg, args.batch_size)
    out = np.stack(descs, axis=0)
    if not is_primary():
        return out
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
