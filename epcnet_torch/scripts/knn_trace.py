"""Where the kNN graph's time goes on the card (counterpart of
``scripts/hw_knn_trace.py``).

  python -m epcnet_torch.scripts.knn_trace [--b 8] [--n 4096] [--k 20] \\
      [--device cuda] [--out build/knn_trace.json]

Three measurements, in one process, on B seeded uniform clouds:

1. Trace. The full-width EPC-Net (``ModelConfig()`` at N and k; seeded
   random weights) embeds the clouds three times under ``torch.profiler``,
   after one forward outside it. Kept: the device ops ranked by time
   (``top_device_ops``), the model's named spans (``region_ms``: the kNN
   graph, the indicator cast, each ProxyConv and the A @ F inside it, the
   lift, G-VLAD), and the Chrome trace, ``knn_trace_profile/trace.json``
   beside ``--out``.
2. Phase ablation. K5 (``csrc/knn_phase.cu``) stopped after successive
   phases of the selection, and K1 in full:

     A_slab_1round     the scan, 1 distinct value      slab_plus_fixed = A
     B_slab_krounds    the scan, k distinct values     value_rounds = B - A
     C_plus_threshold  k values + the count            threshold_count = C - B
     D_full_shipped    K1 (``knn_adjacency``)          selection_tail_write_proxy = D - C

   The JAX script calls the last share ``trim_adjwrite_proxy``. K1 on the
   card has no trim, hence the other name. For k <= 32 K5 runs the phase
   prefix of the tiled core that K1 runs (``csrc/knn_tile.cuh``: the same
   block, tiles, threads a row, threshold and queue), with a list of
   distinct values where K1 keeps (d, j). So A is the slab and the scan
   (the cloud streamed through shared memory, every distance, the
   threshold compare, and the flushes of a 1-value list on 24 register
   slots, 23 of them fixed); B - A what selecting k distinct values adds;
   C - B the count, carried beside each value (phase B carries none); and
   D - C the tail of one core: K1's (d, j) merge of the S lists, the
   indicator write and the proxy. For k > 32 both kernels run the value
   rounds (``csrc/knn_core.cuh``), except A, whose 1 round is always on the
   tiled core. ``phase_cores`` says which core each phase ran, as the
   kernels' C entries reported it ("plain" on the CPU).
3. K6 (``csrc/knn_pipelined.cu``) against K1. For k <= 32 K6 is K1's
   tiled selection fed by a producer warp (bulk copies into a ring of
   stages, no block barrier a tile) that also zeroes the indicator while
   the consumers select: it tests load latency, the per-tile barrier and
   the serial zero-fill against K1 on the same cloud. K6's indicator must
   equal K1's and its fp32 proxy its plain version's within 1e-6 relative;
   then both are timed, in turns. ``verdict`` is "faster" if K6 is exact
   and under 0.97 x K1, else "rejected" (the JAX script's rule).

The result is printed as one JSON line and written to ``--out``. On the card
every time is a mean over launches by CUDA events (``cuda_ms``). With
``--device cpu`` the plain versions run and the times are host-clock medians
(``"timer": "host"``): that drives the script at a tiny size in the CPU
tests, and none of those numbers is a device time. Without a card the
default ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from epcnet_torch.configs import ModelConfig
from epcnet_torch.device import resolve_device
from epcnet_torch.ops.knn import knn_adjacency, knn_adjacency_cuda
from epcnet_torch.ops.knn_phases import (
    knn_adjacency_pipelined,
    knn_adjacency_pipelined_plain,
    knn_phase,
    knn_phase_cuda,
)
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.utils.profiling import region_ms, start_trace, top_device_ops
from epcnet_torch.utils.timing import cuda_ms, device_sync, timeit
from epcnet_torch.weights import init_flat_variables

TRACED_FORWARDS = 3


def clouds(b: int, n: int, seed: int = 0) -> np.ndarray:
    """[B, N, 3] fp32 uniform in [-1, 1], from a numpy seed (the JAX
    script's clouds)."""
    return np.random.default_rng(seed).uniform(-1, 1, (b, n, 3)).astype(np.float32)


def _time_ms(device: torch.device):
    """fn, reps -> ms a call: CUDA events on the card, the host clock on the
    CPU."""
    if device.type == "cuda":
        return cuda_ms
    return lambda fn, reps: timeit(fn, iters=reps, warmup=1) * 1e3


def _reps(b: int, n: int) -> int:
    # about 20 launches at B=8, N=4096 and 3 at B=2, N=32768
    return max(3, min(20, round(4e9 / (b * n * n))))


def trace_forward(cfg: ModelConfig, x: torch.Tensor, trace_dir: str) -> dict:
    """Profile ``TRACED_FORWARDS`` forwards of the model on x (after one
    outside the trace); totals are over all traced forwards. Then time the
    forward outside the trace (``forward_ms``, the mean of 3): set beside
    ``total_ms / forwards``, the device's busy time, it gives the device's
    idle share within a forward."""
    embed = build_embed_fn(cfg, device=x.device,
                           variables=init_flat_variables(cfg, seed=0))
    device_sync(embed(x))  # kernel builds and the allocator, outside the trace
    with start_trace(trace_dir) as prof:
        for _ in range(TRACED_FORWARDS):
            device_sync(embed(x))
    ops = top_device_ops(prof)
    return {"forwards": TRACED_FORWARDS, "dir": trace_dir, "ranked_by": ops["ranked_by"],
            "total_ms": ops["total_ms"], "top_ops": ops["top"],
            "regions_ms": region_ms(prof, "epcnet/"),
            "forward_ms": _time_ms(x.device)(lambda: embed(x), 3)}


def _core(fn, counter) -> str:
    """The core one call of fn ran, from the launches ``counter`` (a
    wrapper's ``launches_rounds``) gained."""
    rounds = counter.launches_rounds
    fn()
    return "value rounds" if counter.launches_rounds > rounds else "tiled"


def phase_ablation(x: torch.Tensor, k: int) -> dict:
    """Phases A-D on x [B, N, 3] and their attribution, in ms a batch."""
    b, n, _ = x.shape
    reps = _reps(b, n)
    time_ms = _time_ms(x.device)
    phases = {
        "A_slab_1round": lambda: knn_phase(x, 1),
        "B_slab_krounds": lambda: knn_phase(x, k),
        "C_plus_threshold": lambda: knn_phase(x, k, thresh=True),
        "D_full_shipped": lambda: knn_adjacency(x, k, torch.bfloat16),
    }
    if x.device.type == "cuda":
        cores = {name: _core(fn, knn_adjacency_cuda if name[0] == "D" else knn_phase_cuda)
                 for name, fn in phases.items()}
        k5 = {cores[p] for p in ("A_slab_1round", "B_slab_krounds", "C_plus_threshold")}
        k5_core = k5.pop() if len(k5) == 1 else f"A {cores['A_slab_1round']}, B-C " \
            f"{cores['B_slab_krounds']}"
        phase_cores = {"A-C (K5)": k5_core, "D (K1)": cores["D_full_shipped"]}
    else:
        phase_cores = {"A-C (K5)": "plain", "D (K1)": "plain"}
    ms = {name: time_ms(fn, reps) for name, fn in phases.items()}
    return {
        "batch": b, "n": n, "k": k, "reps": reps,
        "phase_ms_per_batch": ms,
        "phase_cores": phase_cores,
        "attribution_ms": {
            "slab_plus_fixed": ms["A_slab_1round"],
            "value_rounds": ms["B_slab_krounds"] - ms["A_slab_1round"],
            "threshold_count": ms["C_plus_threshold"] - ms["B_slab_krounds"],
            "selection_tail_write_proxy": ms["D_full_shipped"] - ms["C_plus_threshold"],
        },
    }


def pipelined_vs_k1(x: torch.Tensor, k: int) -> dict:
    """K6 against K1 on x: exactness first, then both timed in turns (K6,
    K1, K1, K6), each the mean of its two turns."""
    b, n, _ = x.shape
    reps = _reps(b, n)
    adj6, proxy6 = knn_adjacency_pipelined(x, k)
    adj1, _ = knn_adjacency(x, k, torch.bfloat16)
    _, proxy_p = knn_adjacency_pipelined_plain(x, k)
    err = (proxy6 - proxy_p).abs()
    adj_ok = torch.equal(adj6, adj1)
    proxy_ok = bool((err <= 1e-6 * proxy_p.abs() + 1e-7).all())
    del adj6, adj1
    time_ms = _time_ms(x.device)

    def k6():
        return knn_adjacency_pipelined(x, k)

    def k1():
        return knn_adjacency(x, k, torch.bfloat16)

    turns = [(name, time_ms(fn, reps)) for name, fn in
             (("k6", k6), ("k1", k1), ("k1", k1), ("k6", k6))]
    pipe_ms = sum(t for name, t in turns if name == "k6") / 2
    ship_ms = sum(t for name, t in turns if name == "k1") / 2
    return {
        "adj_exact": adj_ok,
        "proxy_within_1e-6_rel": proxy_ok,
        "proxy_max_abs_err": float(err.max()),
        "pipelined_ms_per_batch": pipe_ms,
        "shipped_ms_per_batch_same_process": ship_ms,
        "verdict": "faster" if adj_ok and proxy_ok and pipe_ms < 0.97 * ship_ms
        else "rejected",
    }


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--b", type=int, default=8, help="clouds a batch")
    p.add_argument("--n", type=int, default=4096, help="points a cloud")
    p.add_argument("--k", type=int, default=20, help="neighbours a point")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=os.path.join("build", "knn_trace.json"))
    return p


def main(argv: list[str] | None = None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    out_dir = os.path.dirname(args.out) or "."
    trace_dir = os.path.join(out_dir, "knn_trace_profile")
    cfg = ModelConfig().variant(num_points=args.n, knn_k=args.k)
    x = torch.tensor(clouds(args.b, args.n), device=dev)

    out: dict = {
        "metric": "knn_trace_attribution",
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "timer": "cuda_events" if on_card else "host",
        "batch": args.b, "n": args.n, "k": args.k,
    }
    out["trace"] = trace_forward(cfg, x, trace_dir)
    ablation = phase_ablation(x, args.k)
    out["reps"] = ablation["reps"]
    out["phase_ms_per_batch"] = ablation["phase_ms_per_batch"]
    out["attribution_ms"] = ablation["attribution_ms"]
    out["phase_cores"] = ablation["phase_cores"]
    out["pipelined"] = pipelined_vs_k1(x, args.k)

    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
