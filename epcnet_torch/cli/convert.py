"""Checkpoint-import CLI (counterpart of ``epcnet_tpu/cli/convert.py``):
external weights -> a run directory that the port's ``serve``, ``evaluate``,
``embed`` and ``train --restore`` consume directly.

  python -m epcnet_torch.cli.convert --source weights.npz --log_dir out \\
      [--name_map self|tf1_epcnet|tf1_pointnetvlad|auto] \\
      [--source_format tf|torch] [--config cfg.json | --set model.x=y ...] \
      [--device cpu]

Writes ``<log_dir>/config.json``, a port checkpoint at step 0
(``<log_dir>/ckpt``, ``train/checkpoint.py``) and the ``<log_dir>/export``
pair (``weights.save_export``). The step-0 train state is built on the card
unless ``--device cpu`` is given; without a card the default raises before
any work.

Source formats (by extension):
  - ``.npz``           numpy archive of name -> array
  - ``.pt/.pth/.bin``  ``torch.load(weights_only=True)``; a wrapping
                       ``{"state_dict": ...}`` is unwrapped
  - ``.pkl/.pickle``   a pickled name -> array dict (only for files you trust:
                       unpickling runs code)

Matching strategies (``--name_map``, ``utils/importer.py``):
  - ``self`` (default when every key is ``params/...`` or
    ``batch_stats/...``): the flat layout of ``cli/export.py`` in either
    package, a lossless re-import; every leaf must be there.
  - ``tf1_pointnetvlad`` / ``tf1_epcnet``: the regex NAME_MAPS.
  - ``auto``: the shape matcher for unlabelled dicts in leaf order; fails
    loudly on any unmatched leaf.

Verify a fresh import with known descriptors (``cli/embed.py``) before
trusting recall numbers.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from epcnet_torch.configs import ExperimentConfig, apply_overrides
from epcnet_torch.device import resolve_device
from epcnet_torch.train.checkpoint import CheckpointManager
from epcnet_torch.train.state import create_train_state
from epcnet_torch.utils.importer import (
    NAME_MAPS,
    automatch_state_dict,
    import_state_dict,
    merge_into_variables,
)
from epcnet_torch.utils.logging import log_string
from epcnet_torch.weights import init_flat_variables, save_export

_TORCH_EXT = (".pt", ".pth", ".bin")


def load_source(path: str) -> dict[str, np.ndarray]:
    """One file -> flat {name: np.ndarray} state dict."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path, allow_pickle=False) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    if ext in _TORCH_EXT:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
            obj = obj["state_dict"]
        return {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
                for k, v in obj.items()}
    if ext in (".pkl", ".pickle"):
        with open(path, "rb") as f:
            obj = pickle.load(f)
        return {k: np.asarray(v) for k, v in obj.items()}
    raise ValueError(f"unrecognized source extension {ext!r} ({path})")


def main(argv=None) -> str:
    """Returns the output run directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True, help="weights file (see module doc)")
    ap.add_argument("--log_dir", required=True, help="output run directory")
    ap.add_argument("--config", default=None,
                    help="experiment config JSON for the target model")
    ap.add_argument("--set", action="append", default=[], dest="overrides")
    ap.add_argument("--name_map", default=None,
                    choices=sorted(NAME_MAPS) + ["auto", "self"],
                    help="matching strategy (default: self if keys look like "
                    "params/..., else auto)")
    ap.add_argument("--source_format", default="tf", choices=("tf", "torch"),
                    help="source layout for kernel/centroid conversions "
                    "(torch for .pt/.pth/.bin)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # before any work: no card, no conversion

    cfg = ExperimentConfig()
    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    sd = load_source(args.source)
    log_string(f"loaded {len(sd)} source arrays from {args.source}")
    source = args.source_format
    if os.path.splitext(args.source)[1].lower() in _TORCH_EXT:
        # torch archives take torch layouts: "tf" would shape-match square
        # kernels untransposed and import wrong weights
        source = "torch"

    strategy = args.name_map
    if strategy is None:
        selfish = all(k.startswith(("params/", "batch_stats/")) for k in sd)
        strategy = "self" if selfish else "auto"
        log_string(f"auto-selected --name_map {strategy}")

    base = init_flat_variables(cfg.model, cfg.train.seed)
    if strategy == "self":
        # a truncated or empty archive must fail, not convert to
        # part-random weights
        missing = sorted(set(base) - set(sd))
        if missing:
            raise ValueError(f"self-layout import is missing {len(missing)} of "
                             f"{len(base)} model leaves (truncated archive?): "
                             f"{missing[:5]}...")
        imported = sd
    elif strategy == "auto":
        imported = automatch_state_dict(sd, base, source=source)
    else:
        imported = import_state_dict(sd, NAME_MAPS[strategy], source=source)
    flat = merge_into_variables(base, imported)

    os.makedirs(args.log_dir, exist_ok=True)
    with open(os.path.join(args.log_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    state = create_train_state(cfg.model, cfg.train, dev, variables=flat)
    CheckpointManager(os.path.join(args.log_dir, "ckpt"),
                      cfg.train.keep_checkpoints).save(state)
    save_export(os.path.join(args.log_dir, "export"), cfg, flat, step=0)
    log_string(f"imported via {strategy!r} -> {args.log_dir} (step-0 checkpoint and the "
               "export pair; serve/evaluate/embed/train --restore can use it now)")
    return args.log_dir


if __name__ == "__main__":
    main()
