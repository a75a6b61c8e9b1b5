"""What the harness and the reference load: never JAX, jaxlib, flax, optax,
orbax or the JAX package (top-level names compared whole: the port's name
begins with the JAX package's), and the reference nothing of the port."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from bench_h100 import harness

BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "epcnet_tpu"}


def _loaded(code: str) -> set[str]:
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    kinds = {harness.load_json(harness.HERE, "workloads", w["name"] + ".json")["kind"]
             for w in bench["workloads"]}
    code = ("from bench_h100 import harness, program, readings\n"
            + "".join(f"harness.load_module('traffic', {k!r})\n" for k in sorted(kinds))
            + "".join(f"harness.load_module('metrics', {m['name']!r})\n"
                      for m in bench["per_layer"]))
    top = _loaded(code)
    assert "epcnet_torch" in top  # the system under test is loaded ...
    assert not top & BANNED  # ... and nothing of JAX


def test_reference_loads_no_port():
    top = _loaded("import bench_h100.reference.model, bench_h100.reference.train, "
                  "bench_h100.reference.retrieval, bench_h100.reference.precision")
    assert not top & (BANNED | {"epcnet_torch"})


def test_banned_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "epcnet_tpu_like", sys)
    assert harness.banned_modules() == sorted(BANNED & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "optax.schedules", sys)
    assert "optax" in harness.banned_modules()
