"""Seeded weights for DGCNN-VLAD, made on the device, with the distributions
of ``weights.py``.

``leaves(model)`` lists every parameter and BN statistic of the model by
the ``state_dict`` key the port's ``models/dgcnn.py`` gives it (a Dense
weight [out, in]), worked out from the sizes alone: ``edgeconv_{i}.dense``
(2 C_in -> C_i, no bias) and ``edgeconv_{i}.bn``, ``lift.dense_0`` (no
bias) and ``lift.bn_0`` (conv5), and the ``netvlad`` head (the port's
``GVLADHead`` with one group: assignment, centroids, the one grouped FC,
the gate). ``make_weights`` draws them as ``weights.make_weights`` does:
He-scaled weights where BN and the activation follow, the sharp VLAD
assignment (g = 10), LeCun in the head after it, BN scale 1 + N(0, 0.1²),
bias and running mean N(0, 0.1²), running variance U(0.5, 1.5). The port
takes them in its flat naming through ``weights.to_flat``.
"""

from __future__ import annotations

import math

import torch


def leaves(model: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(state_dict key, shape, init) of every leaf, parameters then BN
    statistics."""
    out: list = []

    def bn(path, width):
        out.extend([(f"{path}.scale", (width,), "bn_scale"),
                    (f"{path}.bias", (width,), "bn_bias")])

    fan = 3
    for i, ch in enumerate(model["proxyconv_channels"]):
        out.append((f"edgeconv_{i}.dense.weight", (ch, 2 * fan), "he"))
        bn(f"edgeconv_{i}.bn", ch)
        fan = ch
    fan = sum(model["proxyconv_channels"])
    for j, width in enumerate(model["lift_channels"]):
        out.append((f"lift.dense_{j}.weight", (width, fan), "he"))
        bn(f"lift.bn_{j}", width)
        fan = width
    c, d, g = model["vlad_clusters"], model["feature_dim"], model["vlad_groups"]
    gd, out_dim = model["vlad_group_dim"], model["output_dim"]
    if not (g == 1 and gd == out_dim):
        raise ValueError("DGCNN-VLAD's head is NetVLAD's: one group of output_dim")
    out.append(("netvlad.assign.weight", (c, d), "assign"))
    out.append(("netvlad.assign.bias", (c,), "bias"))
    out.append(("netvlad.centroids", (c, d), "centroids"))
    out.append(("netvlad.group_w", (g, c * d // g, gd), "group_w"))
    out.append(("netvlad.group_b", (g, gd), "bias"))
    if model["gating"]:
        out.append(("netvlad.gate.weight", (out_dim, out_dim), "lecun"))
        out.append(("netvlad.gate.bias", (out_dim,), "bias"))
    for key, shape, init in list(out):
        if init == "bn_scale":
            path = key.rsplit(".", 1)[0]
            out.append((f"{path}.mean", shape, "bn_mean"))
            out.append((f"{path}.var", shape, "bn_var"))
    return out


def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf of ``leaves(model)`` as an fp32 tensor on ``device``, from
    a ``torch.Generator`` seeded with ``seed`` (one normal and one uniform
    draw for all of them, each leaf scaled from its slice)."""
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
        elif init in ("group_w", "centroids"):
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
