"""The ctypes signatures the port passes to ``_build.launch`` / ``_build.call``
against the C entries of ``epcnet_torch/csrc``, read from the sources.

ctypes checks only that enough arguments are given, on the card and at
call time; a letter too many or in the wrong place (an int where the entry
takes a pointer) is caught here, on the CPU, where no kernel builds.
"""

import re
from pathlib import Path

import pytest

from epcnet_torch.ops import _build

PKG = Path(_build.__file__).resolve().parent.parent


def _c_entries() -> dict:
    """{(source, symbol): letters} of every ``extern "C"`` entry: p for a
    pointer, i for an int, f for a float."""
    out = {}
    for name in _build.SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        for sym, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            letters = ""
            for p in params.split(","):
                p = " ".join(p.split())
                letters += "p" if "*" in p else "f" if p.startswith("float") else "i"
                assert "*" in p or p.startswith(("int ", "float ")), (sym, p)
            out[(name, sym)] = letters
    return out


def _py_calls() -> dict:
    """{(source, symbol): letters} of every ``_build.launch`` / ``_build.call``
    in the port's Python."""
    out = {}
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        for src, sym, sig in re.findall(
                r'_build\.(?:launch|call)\(\s*"(\w+)",\s*"(\w+)",\s*"(\w+)"', text):
            assert out.get((src, sym), sig) == sig, (src, sym, path)
            out[(src, sym)] = sig
    return out


def test_every_entry_is_called():
    assert set(_py_calls()) == set(_c_entries())


@pytest.mark.parametrize("entry", sorted(_c_entries()), ids=lambda e: e[1])
def test_signature_matches_c_entry(entry):
    assert _py_calls()[entry] == _c_entries()[entry]
