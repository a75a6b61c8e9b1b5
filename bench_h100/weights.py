"""Seeded weights for EPC-Net and EPC-Net-L, made on the device.

``leaves(model)`` lists every parameter and BN statistic of the model a
configuration describes, by the ``state_dict`` key the port's modules give
it (torch layout: a Dense weight is [out, in]), worked out from the sizes
alone. ``make_weights`` draws them all from one ``torch.Generator`` on the
device in two calls (one normal, one uniform) and scales each leaf's slice:

- Dense weights normal with std g / sqrt(fan_in): g = sqrt(2) where BN and
  ReLU follow (ProxyConv, lift), g = 10 for the VLAD assignment (a sharp
  soft-assignment, as a trained NetVLAD has), g = 1 in the head after it;
- centroids normal with std 1 / sqrt(D), biases normal with std 0.02;
- BN scale 1 + N(0, 0.1²), bias and running mean N(0, 0.1²), running
  variance U(0.5, 1.5), so that BN does real work in every check.

The same tensors go to the reference as they are and to the port in its
flat naming (``to_flat``: ``params/<path>/kernel`` [in, out],
``batch_stats/<path>/mean``), through ``load_flat_variables``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def leaves(model: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(state_dict key, shape, init) of every leaf, parameters then BN
    statistics. ``init`` names the distribution (see the module docstring)."""
    out: list = []

    def dense(path, fan_in, width, init):
        out.append((f"{path}.weight", (width, fan_in), init))
        out.append((f"{path}.bias", (width,), "bias"))

    def bn(path, width):
        out.extend([(f"{path}.scale", (width,), "bn_scale"),
                    (f"{path}.bias", (width,), "bn_bias")])

    fan = 3
    for i, ch in enumerate(model["proxyconv_channels"]):
        dense(f"proxyconv_{i}.dense", 2 * fan, ch, "he")
        bn(f"proxyconv_{i}.bn", ch)
        fan = ch
    fan = sum(model["proxyconv_channels"])
    for j, width in enumerate(model["lift_channels"]):
        dense(f"lift.dense_{j}", fan, width, "he")
        bn(f"lift.bn_{j}", width)
        fan = width
    c, d, g = model["vlad_clusters"], model["feature_dim"], model["vlad_groups"]
    gd, out_dim = model["vlad_group_dim"], model["output_dim"]
    dense("gvlad.assign", d, c, "assign")
    out.append(("gvlad.centroids", (c, d), "centroids"))
    out.append(("gvlad.group_w", (g, c * d // g, gd), "group_w"))
    out.append(("gvlad.group_b", (g, gd), "bias"))
    if not (g == 1 and gd == out_dim):
        dense("gvlad.out_fc", g * gd, out_dim, "lecun")
    if model["gating"]:
        dense("gvlad.gate", out_dim, out_dim, "lecun")
    # BN running statistics last, as the port's buffers come after its parameters
    for key, shape, init in list(out):
        if init == "bn_scale":
            path = key.rsplit(".", 1)[0]
            out.append((f"{path}.mean", shape, "bn_mean"))
            out.append((f"{path}.var", shape, "bn_var"))
    return out


def is_statistic(key: str) -> bool:
    """True for a BN running statistic (a buffer, not a parameter)."""
    return key.endswith((".mean", ".var"))


def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf of ``leaves(model)`` as an fp32 tensor on ``device``,
    from a ``torch.Generator`` seeded with ``seed``."""
    spec = leaves(model)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(sum(sizes), generator=gen, device=device)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (key, shape, init), size in zip(spec, sizes):
        zs, us = z[at:at + size].view(shape), u[at:at + size].view(shape)
        at += size
        if init in ("he", "assign", "lecun"):
            gain = {"he": math.sqrt(2.0), "assign": 10.0, "lecun": 1.0}[init]
            v = zs * (gain / math.sqrt(shape[1]))
        elif init == "group_w":
            v = zs / math.sqrt(shape[1])
        elif init == "centroids":
            v = zs / math.sqrt(shape[1])
        elif init == "bias":
            v = zs * 0.02
        elif init == "bn_scale":
            v = 1.0 + 0.1 * zs
        elif init in ("bn_bias", "bn_mean"):
            v = 0.1 * zs
        else:  # bn_var
            v = 0.5 + us
        out[key] = v.contiguous()
    return out


def to_flat(weights: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's flat naming of ``weights`` (numpy fp32): a Dense weight
    [out, in] becomes ``params/<path>/kernel`` [in, out], a BN statistic
    ``batch_stats/<path>/<mean|var>``, anything else ``params/<path>/<leaf>``."""
    flat = {}
    for key, t in weights.items():
        path = key.split(".")
        v = t.detach().float().cpu().numpy()
        if path[-1] == "weight":
            path[-1], v = "kernel", v.T
        section = "batch_stats" if is_statistic(key) else "params"
        flat[section + "/" + "/".join(path)] = np.ascontiguousarray(v)
    return flat
