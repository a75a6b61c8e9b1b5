"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

  python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run: set-up (weights and inputs from the seed, the program built and
every shape of the cell warmed; ``setup_s`` is the time from the process's
start to here), the window of ``--seconds``, the peak of device memory,
the program's state freed, then the correctness check against the plain
reference. With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics; with ``--trace 1`` a stretch of the window is profiled
and the metrics are its per-layer ones, with the device's busy time and a
breakdown.

The last line of standard output is the result, one JSON object; the
numbers the check compared, each with its limit, end both it (under
``check``) and standard error. Without a card, or with fewer than the cell
asks for, the run prints no result and exits with 2; if JAX or the JAX
package was loaded, with 4.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "bench_h100")
BANNED = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "epcnet_tpu"})
# every build and kernel cache of a run, at a fixed path inside the checkout
CACHE = os.path.join(ROOT, "build", "bench_h100")


def process_age_s() -> float:
    """Seconds since this process started (Linux's /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(folder: str, name: str) -> types.ModuleType:
    """``bench_h100/<folder>/<name>.py`` (a name may hold dots)."""
    path = os.path.join(HERE, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_h100.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell as the files describe it: its entry in ``BENCHMARK.json``,
    its workload file, its configuration and the metrics it reports."""

    def __init__(self, name: str):
        bench = load_json(ROOT, "BENCHMARK.json")
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entries[name]
        self.workload = load_json(HERE, "workloads", name + ".json")
        for key in ("config", "traffic"):
            if self.workload[key] != self.entry[key]:
                raise ValueError(f"{name}: workload file's {key} {self.workload[key]!r} != "
                                 f"BENCHMARK.json's {self.entry[key]!r}")
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(ROOT, configs[self.entry["config"]]["file"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [])
                          or ("workloads" not in m and m["moves"] in reported)]

    def kind(self, device, seed: int, control: bool = False, model: dict | None = None,
             params: dict | None = None):
        mod = load_module("traffic", self.workload["kind"])
        return mod.Kind(model or self.config["model"], self.config.get("train", {}),
                        {**self.workload["params"], **(params or {})}, device, seed,
                        control=control)


def read_per_layer(cell: Cell, kind) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    for."""
    obs = types.SimpleNamespace(trace=kind.trace, counters=kind.counters,
                                model=kind.model, params=kind.params)
    out = {}
    for m in cell.per_layer:
        value = load_module("metrics", m["name"]).read(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float, kind=None) -> dict:
    """One run of ``cell``: the result object (without ``device``'s card
    fields), with ``info`` and ``numbers`` (every number the check worked
    out) before ``check``. ``started``: the run's start on
    ``time.perf_counter``'s clock. ``kind``: the traffic object to drive
    (the control, a planted fault or a resized one), else the cell's own."""
    import torch

    from bench_h100.trace import warm_profiler

    cuda = torch.device(device).type == "cuda"
    if cuda and torch.cuda.is_initialized():  # a run before this one in the process
        torch.cuda.reset_peak_memory_stats(device)
    kind = kind or cell.kind(device, seed)
    kind.setup()
    if trace:
        warm_profiler(device)
    setup_s = time.perf_counter() - started
    e2e = kind.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    if trace:
        metrics = read_per_layer(cell, kind)
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = kind.check()
    info = {**getattr(kind, "info", {}), "check_s": time.perf_counter() - t_check}
    limits = cell.workload["limits"]
    check = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = kind.failed == 0 and all(c["value"] <= c["limit"] for c in check.values())
    out = {"correct": bool(correct), "attempted": int(kind.attempted),
           "failed": int(kind.failed), "metrics": metrics,
           "device": {"memory_peak_bytes": int(peak)}}
    if trace and kind.trace is not None:
        t = kind.trace
        out["device"]["busy_s"] = t.busy_s()
        out["device"]["window_s"] = t.stretch_s
        out["breakdown"] = t.breakdown()
        # how far the profiler slows a unit: inside the stretch and outside
        info["unit_ms"] = {"traced": t.stretch_s / t.units * 1e3 if t.units else None,
                           "outside": t.unit_s * 1e3 if t.unit_s else None}
    out["info"], out["numbers"] = info, numbers
    out["check"] = check
    return out


def main(argv=None) -> int:
    started = time.perf_counter() - process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    cell = Cell(args.workload)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_h100: {cell.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from bench_h100 import program

    program.enable_compilation_cache(os.path.join(CACHE, "kernels"))
    device = torch.device("cuda:0")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, started)
    found = banned_modules()
    if found:
        print(f"bench_h100: loaded {found}: the benchmark may not load JAX or the "
              "JAX package", file=sys.stderr)
        return 4
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                     "count": chips, **out["device"]}
    print(json.dumps({"info": out.pop("info"), "numbers": out.pop("numbers")}),
          file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0
