"""Readings that set a cell's correctness limits and its fixed load; not
part of a benchmark run.

  # the program on a dozen seeds and the control on three, one process,
  # each with a short window at the cell's own load
  python3 bench_h100/readings.py --workload <cell> --seeds 1,2,...,12 \\
      --control_seeds 101,102,103 --seconds 2 --out chiprun_out/readings.jsonl

  # a training cell's faults, planted in the port (the readings that set a
  # limit's upper end), and where the program's first step picks other
  # hardest negatives than the reference's
  python3 bench_h100/readings.py --workload epcnet.train.tuples_b2 \\
      --seeds 1,2,3 --fault half_batch --picks

  # a serving cell's rate sweep: one set-up, one window a rate
  python3 bench_h100/readings.py --workload epcnet.serve.poisson_1e6 \\
      --seeds 7 --rates 1200,1600,2000,4000 --seconds 6

Each seed is a run through the harness's own sequence and prints one JSON
line: every number the check works out (the program's give a limit's lower
reading, the control's its upper one), the end-to-end values with
``setup_s`` (from the seed's set-up on), the peak of device memory and the
time the check took; a rate of the
sweep prints the offered and answered rates and the latencies. The lines
also go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from bench_h100 import harness  # noqa: E402


def _emit(row: dict, out) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def one(cell, seed: int, seconds: float, control: bool, device) -> dict:
    """A run of the cell through the harness's own sequence
    (``harness.run_cell``), the program or the control in its place."""
    started = time.perf_counter()
    out = harness.run_cell(cell, seed, seconds, False, device, started,
                           kind=cell.kind(device, seed, control=control))
    return {"seed": seed, "control": control, "correct": out["correct"],
            "numbers": out["numbers"], "metrics": out["metrics"],
            "attempted": out["attempted"], "failed": out["failed"],
            "memory_peak_bytes": out["device"]["memory_peak_bytes"], "info": out["info"]}


def plant_fault(name: str) -> None:
    """Break the port's training step in this process: ``half_batch`` runs
    each step on the first half of its tuples (the mean over the rest),
    ``unchanged`` leaves the state as it was (no optimiser update, no BN
    running update)."""
    import epcnet_torch.train.step as step

    if name == "half_batch":
        to_device = step.to_device
        step.to_device = lambda batch, device: to_device(
            {k: v[: len(v) // 2] for k, v in batch.items()}, device)
    elif name == "unchanged":
        def no_update(state, lr, accum, group=None):
            state.step += 1

        step._apply_update = no_update
        step.commit_batch_stats = lambda model: 0
    else:
        raise ValueError(f"unknown fault {name!r}")


def hinge_picks(cell, seed: int, device) -> dict:
    """The first step's hardest negatives (the lazy quadruplet's two maxima
    over negatives) and nearest positives, by the port's train-mode
    forward and by the reference's, on the first batch at the seed's
    weights; with the reference's margin between its two largest hinges."""
    import torch

    from bench_h100 import data, program
    from bench_h100.reference import model as ref_model
    from bench_h100.reference.train import flatten
    from bench_h100.weights import make_weights, to_flat
    from epcnet_torch.models import get_model
    from epcnet_torch.weights import load_flat_variables

    kind = cell.kind(device, seed)
    p, model = kind.params, kind.model
    w = make_weights(model, data.torch_seed(seed, "weights"), device)
    batch = data.tuple_batch(data.rng(seed, "batches"), p["tuples"], p["positives"],
                             p["negatives"], model["num_points"])
    clouds, b, npos, ng = flatten(batch, device)
    port = get_model(program.model_config(model), device)
    load_flat_variables(port, to_flat(w))
    with torch.no_grad():
        mom = 1.0 - kind.train["bn_init_decay"]
        descs = {"port": port(clouds, train=True, momentum=mom).float(),
                 "reference": ref_model.forward(w, model, clouds, train=True, stats={})}
    out = {}
    for side, d in descs.items():
        d = d.reshape(b, -1, d.shape[-1])
        q, pos, neg, other = d[:, 0], d[:, 1:1 + npos], d[:, 1 + npos:1 + npos + ng], d[:, -1]
        dp = ((pos - q[:, None]) ** 2).sum(-1)
        h1 = -((neg - q[:, None]) ** 2).sum(-1)
        h2 = -((neg - other[:, None]) ** 2).sum(-1)
        top1, top2 = h1.topk(2, -1).values, h2.topk(2, -1).values
        out[side] = {"pos": dp.argmin(-1).tolist(), "neg1": h1.argmax(-1).tolist(),
                     "neg2": h2.argmax(-1).tolist(),
                     "margin1": (top1[:, 0] - top1[:, 1]).tolist(),
                     "margin2": (top2[:, 0] - top2[:, 1]).tolist()}
    out["same_picks"] = all(out["port"][k] == out["reference"][k]
                            for k in ("pos", "neg1", "neg2"))
    out["desc_gap"] = float((descs["port"] - descs["reference"]).norm(dim=1).max())
    return out


def sweep(cell, seed: int, rates, seconds: float, device, out) -> None:
    kind = cell.kind(device, seed)
    kind.setup()
    for rate in rates:
        kind.params["rate_per_s"] = rate
        e2e = kind.window(seconds, False)
        _emit({"rate_per_s": rate, "e2e": e2e, "failed": kind.failed,
               "counters": kind.counters, "info": kind.info}, out)
    kind.free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None, help="half_batch or unchanged (training)")
    ap.add_argument("--picks", action="store_true", help="the first step's hinge picks")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from bench_h100 import program

    program.enable_compilation_cache(os.path.join(harness.CACHE, "kernels"))
    device = torch.device("cuda:0")
    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if args.picks:
        for seed in seeds:
            _emit({"workload": cell.name, "seed": seed,
                   "picks": hinge_picks(cell, seed, device)}, args.out)
    if args.fault:
        plant_fault(args.fault)
    if args.rates:
        sweep(cell, seeds[0], [float(r) for r in args.rates.split(",")], args.seconds,
              device, args.out)
        return 0
    for control, group in ((False, seeds),
                           (True, [int(s) for s in args.control_seeds.split(",") if s])):
        for seed in group:
            _emit({"workload": cell.name, "gpu": torch.cuda.get_device_name(device),
                   "fault": args.fault, **one(cell, seed, args.seconds, control, device)},
                  args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
