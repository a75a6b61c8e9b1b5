"""Weights across the two packages, by the flat naming of
``epcnet_tpu/cli/export.py::flatten_variables``:

  params/<module path>/<leaf>       e.g. params/proxyconv_0/dense/kernel
  batch_stats/<module path>/<leaf>  e.g. batch_stats/lift/bn_1/var

A name maps to the ``state_dict`` key ``<module path with dots>.<leaf>``,
with flax's Dense ``kernel`` [in, out] becoming torch's ``weight`` [out, in].
"""

from __future__ import annotations

import json
import os
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


def flat_variables(model: nn.Module) -> dict[str, np.ndarray]:
    """The model's parameters and BN buffers as a ``flatten_variables``
    dict (fp32 numpy, Dense kernels back in flax's [in, out] layout): the
    inverse of ``load_flat_variables``, in the module's registration order
    (``params/...`` first, then ``batch_stats/...``, as the JAX export)."""
    flat = {}
    for key, t in model.named_parameters():
        flat.update([_flat_entry(key, t, False)])
    for key, t in model.named_buffers():
        flat.update([_flat_entry(key, t, True)])
    return flat


def flat_grads(model: nn.Module) -> dict[str, np.ndarray]:
    """Each parameter's ``.grad`` under its flat ``params/...`` name, in the
    layout of the JAX gradient tree (Dense kernels [in, out]); a parameter
    with no gradient maps to zeros, as JAX's gradient of an unused leaf."""
    return dict(_flat_entry(key, p.grad if p.grad is not None else torch.zeros_like(p), False)
                for key, p in model.named_parameters())


def _flat_entry(key: str, t: torch.Tensor, is_buffer: bool) -> tuple[str, np.ndarray]:
    name, transpose = _to_flat_name(key, is_buffer)
    v = t.detach().float().cpu().numpy()
    return name, np.array(v.T if transpose else v, order="C")  # a copy, never a view


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


def save_export(basename: str, cfg: ExperimentConfig, flat: Mapping[str, np.ndarray],
                step: int = 0) -> None:
    """Write ``flat`` as the ``<basename>.npz`` / ``<basename>.json`` pair in
    the format of ``epcnet_tpu/cli/export.py`` (fp32 arrays; a manifest with
    the step, the full experiment config and every leaf's name, shape and
    dtype), which ``load_export`` and the port's CLIs read."""
    flat = {k: np.asarray(v, np.float32) for k, v in flat.items()}
    os.makedirs(os.path.dirname(basename) or ".", exist_ok=True)
    np.savez(basename + ".npz", **flat)
    manifest = {
        "framework": "epcnet_torch",
        "step": int(step),
        "config": json.loads(cfg.to_json()),
        "leaves": [{"name": k, "shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()],
    }
    with open(basename + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def _flat_leaves(cfg: ModelConfig):
    """(state_dict key, flat name, flat shape) of every leaf of the model
    ``cfg.name`` names, parameters then buffers, built on no device."""
    from epcnet_torch.models import model_class

    with torch.device("meta"):
        model = model_class(cfg)(cfg)
    buffers = {k for k, _ in model.named_buffers()}
    for key, t in list(model.named_parameters()) + list(model.named_buffers()):
        name, transpose = _to_flat_name(key, key in buffers)
        yield key, name, tuple(t.shape[::-1]) if transpose else tuple(t.shape)


def init_flat_variables(cfg: ModelConfig, seed: int = 0) -> dict[str, np.ndarray]:
    """Random weights for ``cfg`` in the flat naming, from a numpy seed; the
    layout of names and shapes is that of the model ``cfg.name`` names.

    Kernels are normal with std g/sqrt(fan_in): g = sqrt(2) (He) where BN
    and ReLU follow (ProxyConv, lift, PointNet MLPs, T-Nets), g = 10 for the
    VLAD assignment — a sharp soft-assignment, as a trained NetVLAD has;
    with unit-scale logits the softmax is near uniform and every cloud's
    descriptor looks alike — and g = 1 (LeCun) for the grouped, output and
    gating FCs. Centroids are normal with std 1/sqrt(D), biases small
    normal; BN scale ~ 1 + N(0, 0.1²), bias ~ N(0, 0.1²), and the running
    stats are non-trivial (mean ~ N(0, 0.1²), var ~ U(0.5, 1.5)) so that BN
    does real work in every check. A T-Net's ``transform_w`` is N(0,
    (0.1/16)²) and its ``transform_b`` the identity plus N(0, 0.05²), so
    each transform moves the points by ~0.1-0.2 of their scale."""
    rng = np.random.default_rng(seed)
    head = ("gvlad.", "netvlad.")
    flat = {}
    for key, name, shape in _flat_leaves(cfg):
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight":  # [in, out]
            gain = (10.0 if key.endswith("assign.weight") else
                    1.0 if key.startswith(head) else np.sqrt(2.0))
            v = rng.normal(0.0, gain / np.sqrt(shape[0]), shape)
        elif leaf == "transform_w":  # [256, dim²]
            v = rng.normal(0.0, 0.1 / np.sqrt(shape[0]), shape)
        elif leaf == "transform_b":  # [dim²], the identity plus noise
            dim = int(round(np.sqrt(shape[0])))
            v = np.eye(dim).reshape(-1) + rng.normal(0.0, 0.05, shape)
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


# flax's lecun_normal: a normal truncated to 2 standard deviations, scaled
# back to variance 1 / fan_in (the std of the truncated unit normal)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(rng: np.random.Generator, shape: tuple, fan_in: int) -> np.ndarray:
    z = rng.standard_normal(shape)
    out = np.abs(z) > 2.0
    while out.any():
        z[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(z) > 2.0
    return z * (np.sqrt(1.0 / fan_in) / _TRUNC_STD)


def init_train_variables(cfg: ModelConfig, seed: int = 0) -> dict[str, np.ndarray]:
    """Where training starts: the JAX model's initial weights in
    distribution (flax's initializers), from a numpy seed, in the flat
    naming of the model ``cfg.name`` names. Dense kernels are LeCun normal
    (fan_in their input width; a grouped FC's [G, in, out] counts G x in, as
    flax's variance scaling does), biases zero, BN scale 1, bias 0 and
    running stats (0, 1), centroids normal with std 1/sqrt(D), and a T-Net
    the identity (``transform_w`` zero). The values are not JAX's: its
    init stream is ``jax.random``'s. ``init_flat_variables`` is the other
    seeded init, the checks' (non-trivial BN, sharp VLAD assignment)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, name, shape in _flat_leaves(cfg):
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight":  # [in, out]
            v = _lecun_normal(rng, shape, shape[0])
        elif key.endswith("group_w"):  # [G, in, out]
            v = _lecun_normal(rng, shape, shape[0] * shape[1])
        elif key.endswith("centroids"):
            v = rng.normal(0.0, 1.0 / np.sqrt(shape[1]), shape)
        elif leaf == "transform_b":
            dim = int(round(np.sqrt(shape[0])))
            v = np.eye(dim).reshape(-1)
        elif leaf in ("scale", "var"):
            v = np.ones(shape)
        else:  # biases, running means, transform_w
            v = np.zeros(shape)
        flat[name] = v.astype(np.float32)
    return flat
