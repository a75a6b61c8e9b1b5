"""Seeded weights for MinkLoc3Dv2, made on the device, with the distributions
of ``weights.py`` where they carry over.

``leaves(model)`` lists every parameter and BN statistic by the
``state_dict`` key the port's ``models/minkloc.py`` gives it, worked out from
the sizes alone: ``conv0`` (5³, 1 -> planes[0]), each level's ``down_{i}``
(2³, width kept) with ``down_bn_{i}`` and ``block_{i}`` (two 3³ convs with
``norm1``, ``norm2``, ``eca``, and where the width changes a 1x1
``downsample`` with ``downsample_bn``), the laterals ``conv1x1_{j}`` and
transposed convs ``tconv_{j}``, and GeM's ``gem.p``. A sparse convolution's
``offset_weight`` is [K, Cin, Cout]; a 1x1 conv's ``weight`` [out, in] (the
port's Dense). ``weights.to_flat`` gives the port's flat names.

Scale. A sparse convolution sums over the offsets whose voxel exists, far
fewer than K on these volumetric submaps, so a He scale over K·Cin would
shrink the activations level by level, and one over the mean pairs a row
grows them (the dense blobs hold both the rows with many pairs and the
large activations). Each convolution's weights are drawn
N(0, g / (k_eff · Cin)), k_eff its map's ``PAIRS_PER_ROW`` (from the
reference's own maps over 8 seeded blob submaps of 4096 points), g 2 where
a ReLU came before (He) and 1 for conv0 (its input is 1) and the transposed
convs (their input is a sum, not a ReLU): the ReLU activations stay at
0.7-2 RMS at every level, GeM's outputs at 1-6. The 1x1 convs: the
residuals' He over Cin, the laterals' LeCun; ECA's kernel N(0, 1 / k),
GeM's p 3 (as published); BN as ``weights.py``: scale 1 + N(0, 0.1²), bias
and running mean N(0, 0.1²), running variance U(0.5, 1.5).
"""

from __future__ import annotations

import math

import torch

TOP_DOWN = 2
CONV0_KERNEL = 5
# the pairs of the row a pair belongs to, on average (sum of n_u^2 over the
# sum of n_u, n_u an output row's pairs), for each map on blob submaps of
# 4096 points: the reference's maps over data.blob_submaps(rng 1, 8, 4096).
# Dense blobs hold both the rows with many pairs and the large activations,
# so this, not the plain mean of n_u, keeps a convolution's output at its
# input's scale
PAIRS_PER_ROW = {"conv0": 24.3, "down_0": 1.4, "block_0": 10.8, "down_1": 2.2,
                 "block_1": 15.8, "down_2": 3.6, "block_2": 18.6, "down_3": 4.9,
                 "block_3": 17.9, "up_0": 1.0, "up_1": 1.0}


def eca_kernel(channels: int) -> int:
    t = int(abs((math.log2(channels) + 1) / 2))
    return t if t % 2 else t + 1


def leaves(model: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(state_dict key, shape, init) of every leaf, parameters then BN
    statistics. An init names the map whose pairs scale a sparse conv."""
    planes, width = model["proxyconv_channels"], model["lift_channels"][-1]
    out: list = []

    def bn(path, ch):
        out.extend([(f"{path}.scale", (ch,), "bn_scale"), (f"{path}.bias", (ch,), "bn_bias")])

    def conv(path, k, cin, cout, scale_map, gain=2):
        out.append((f"{path}.offset_weight", (k ** 3, cin, cout), f"map{gain}:{scale_map}"))

    conv("conv0", CONV0_KERNEL, 1, planes[0], "conv0", gain=1)
    bn("bn0", planes[0])
    fan = planes[0]
    for i, plane in enumerate(planes):
        conv(f"down_{i}", 2, fan, fan, f"down_{i}")
        bn(f"down_bn_{i}", fan)
        key = f"block_{i}"
        conv(f"{key}.conv1", 3, fan, plane, key)
        bn(f"{key}.norm1", plane)
        conv(f"{key}.conv2", 3, plane, plane, key)
        bn(f"{key}.norm2", plane)
        out.append((f"{key}.eca.weight", (eca_kernel(plane),), "eca"))
        if fan != plane:
            out.append((f"{key}.downsample.weight", (plane, fan), "he"))
            bn(f"{key}.downsample_bn", plane)
        fan = plane
    for j in range(TOP_DOWN + 1):
        out.append((f"conv1x1_{j}.weight", (width, planes[-1 - j]), "lecun"))
    for j in range(TOP_DOWN):
        conv(f"tconv_{j}", 2, width, width, f"up_{j}", gain=1)
    out.append(("gem.p", (1,), "gem_p"))
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
        if init.startswith("map"):
            gain, name = init[3:].split(":")
            v = zs * math.sqrt(float(gain) / (PAIRS_PER_ROW[name] * shape[1]))
        elif init in ("he", "lecun"):
            v = zs * math.sqrt((2.0 if init == "he" else 1.0) / shape[1])
        elif init == "eca":
            v = zs / math.sqrt(shape[0])
        elif init == "gem_p":
            v = torch.full(shape, 3.0, device=device)
        elif init == "bn_scale":
            v = 1.0 + 0.1 * zs
        elif init in ("bn_bias", "bn_mean"):
            v = 0.1 * zs
        else:  # bn_var
            v = 0.5 + us
        out[key] = v.contiguous()
    return out
