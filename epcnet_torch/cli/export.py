"""Weight-export CLI (counterpart of ``epcnet_tpu/cli/export.py``): the
latest port checkpoint of a run -> the ``<output>.npz`` / ``<output>.json``
export pair.

  python -m epcnet_torch.cli.export --log_dir log [--output log/export]

The pair has the JAX export's format (flat ``params/...`` and
``batch_stats/...`` fp32 arrays; a manifest with the step, the config and
every leaf), so the port's ``cli/evaluate.py`` and ``cli/embed.py``
evaluate a model the port trained, and the JAX model takes its arrays by
their flat names. Only weights cross between the packages: the optimiser's
moments stay in the port's checkpoint. Runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

from epcnet_torch.train.checkpoint import read_run_config, restore_model
from epcnet_torch.utils.logging import log_string
from epcnet_torch.weights import flat_variables, save_export


def main(argv=None) -> str:
    """Returns the output basename."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--log_dir", required=True, help="trained run directory")
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", default=[], dest="overrides")
    ap.add_argument("--output", default=None,
                    help="output basename (default <log_dir>/export)")
    args = ap.parse_args(argv)
    cfg = read_run_config(args.log_dir, args.config, args.overrides)
    model, step = restore_model(args.log_dir, cfg)
    flat = flat_variables(model)
    out = args.output or os.path.join(args.log_dir, "export")
    save_export(out, cfg, flat, step=step)
    nbytes = sum(v.nbytes for v in flat.values())
    log_string(f"exported {len(flat)} arrays ({nbytes / 1e6:.1f} MB fp32) at step {step} "
               f"-> {out}.npz (+ .json manifest)")
    return out


if __name__ == "__main__":
    main()
