"""Weights across the two packages, by the flat naming of
``epcnet_tpu/cli/export.py::flatten_variables``:

  params/<module path>/<leaf>       e.g. params/proxyconv_0/dense/kernel
  batch_stats/<module path>/<leaf>  e.g. batch_stats/lift/bn_1/var

A name maps to the ``state_dict`` key ``<module path with dots>.<leaf>``,
with flax's Dense ``kernel`` [in, out] becoming torch's ``weight`` [out, in].
"""

from __future__ import annotations

import json
from typing import Mapping

import numpy as np
import torch
from torch import nn

from epcnet_torch.configs import ExperimentConfig, ModelConfig


def _to_torch_key(name: str) -> tuple[str, str, bool]:
    """flat name -> (section, state_dict key, transpose?)."""
    section, *path = name.split("/")
    if section not in ("params", "batch_stats") or not path:
        raise KeyError(f"{name!r} is not a params/... or batch_stats/... name")
    transpose = path[-1] == "kernel"
    if transpose:
        path[-1] = "weight"
    return section, ".".join(path), transpose


def _to_flat_name(key: str, is_buffer: bool) -> tuple[str, bool]:
    """state_dict key -> (flat name, transpose?) — the inverse map."""
    path = key.split(".")
    transpose = path[-1] == "weight"
    if transpose:
        path[-1] = "kernel"
    return ("batch_stats/" if is_buffer else "params/") + "/".join(path), transpose


def load_flat_variables(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy a ``flatten_variables`` dict into ``model`` in place. Raises on
    any missing, extra or mis-shaped name, and on a params/batch_stats
    mismatch. Returns the model."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    seen = set()
    staged = []
    for name, arr in flat.items():
        section, key, transpose = _to_torch_key(name)
        target = (buffers if section == "batch_stats" else params).get(key)
        if target is None:
            raise KeyError(f"{name!r} has no counterpart ({key!r}) in the model")
        value = np.asarray(arr, np.float32)
        if transpose:
            value = value.T
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{name!r}: shape {tuple(np.shape(arr))} does not fit "
                             f"{key!r} {tuple(target.shape)}")
        staged.append((target, value))
        seen.add(key)
    missing = sorted((set(params) | set(buffers)) - seen)
    if missing:
        raise KeyError(f"no value for {missing}")
    with torch.no_grad():
        for target, value in staged:
            target.copy_(torch.tensor(value))
    return model


def load_export(basename: str) -> tuple[ExperimentConfig, dict[str, np.ndarray]]:
    """Read the ``<basename>.npz`` / ``<basename>.json`` pair that
    ``epcnet_tpu/cli/export.py`` writes. Returns (config from the manifest,
    flat arrays). Raises if the arrays and the manifest's leaves disagree."""
    with open(basename + ".json") as f:
        manifest = json.load(f)
    with np.load(basename + ".npz") as data:
        flat = {k: data[k] for k in data.files}
    leaves = {leaf["name"]: tuple(leaf["shape"]) for leaf in manifest["leaves"]}
    got = {k: tuple(v.shape) for k, v in flat.items()}
    if leaves != got:
        raise ValueError(f"{basename}: the .npz arrays do not match the "
                         f"manifest's leaves ({sorted(set(leaves) ^ set(got))})")
    return ExperimentConfig.from_dict(manifest["config"]), flat


def init_flat_variables(cfg: ModelConfig, seed: int = 0) -> dict[str, np.ndarray]:
    """Random weights for ``cfg`` in the flat naming, from a numpy seed.

    Kernels are normal with std g/sqrt(fan_in): g = sqrt(2) (He) where BN
    and ReLU follow (ProxyConv, lift), g = 10 for the VLAD assignment — a
    sharp soft-assignment, as a trained NetVLAD has; with unit-scale logits
    the softmax is near uniform and every cloud's descriptor looks alike —
    and g = 1 (LeCun) for the grouped, output and gating FCs. Centroids are
    normal with std 1/sqrt(D), biases small normal; BN scale ~ 1 + N(0,
    0.1²), bias ~ N(0, 0.1²), and the running stats are non-trivial (mean ~
    N(0, 0.1²), var ~ U(0.5, 1.5)) so that BN does real work in every
    check."""
    from epcnet_torch.models import EPCNet  # the layout of names and shapes

    with torch.device("meta"):
        model = EPCNet(cfg)
    rng = np.random.default_rng(seed)
    buffers = {k for k, _ in model.named_buffers()}
    flat = {}
    for key, t in list(model.named_parameters()) + list(model.named_buffers()):
        name, transpose = _to_flat_name(key, key in buffers)
        shape = tuple(t.shape[::-1]) if transpose else tuple(t.shape)
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight":  # [in, out]
            gain = (10.0 if key.startswith("gvlad.assign") else
                    1.0 if key.startswith("gvlad") else np.sqrt(2.0))
            v = rng.normal(0.0, gain / np.sqrt(shape[0]), shape)
        elif key.endswith("group_w"):  # [G, in, out]
            v = rng.normal(0.0, 1.0 / np.sqrt(shape[1]), shape)
        elif key.endswith("centroids"):
            v = rng.normal(0.0, 1.0 / np.sqrt(shape[1]), shape)
        elif leaf == "scale":
            v = 1.0 + rng.normal(0.0, 0.1, shape)
        elif leaf == "mean" or (leaf == "bias" and ".bn" in "." + key):
            v = rng.normal(0.0, 0.1, shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:  # Dense and grouped-FC biases
            v = rng.normal(0.0, 0.02, shape)
        flat[name] = v.astype(np.float32)
    return flat
