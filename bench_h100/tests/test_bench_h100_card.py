"""The command as the benchmark's driver runs it: without a card it prints
no result and exits with 2; on a card (tests marked ``cuda``, skipped
here) each cell runs a short window and comes out correct.

  python -m pytest -q -m cuda bench_h100/tests/test_bench_h100_card.py   # on the card
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench_h100 import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT, "BENCHMARK.json")["workloads"]]


def _run(name: str, seconds: str = "2") -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "bench_h100/run.py", "--workload", name,
                           "--seed", str(2 ** 31 + 11), "--seconds", seconds, "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def test_no_card_no_result(no_card):
    out = _run(CELLS[0])
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    out = _run(name)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
