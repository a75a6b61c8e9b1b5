"""Operations and bytes of MinkLoc3Dv2's convolutions, counted from the pool
by the benchmark's own voxels and kernel maps (``reference/minkloc3dv2.py``),
so that whatever implements the model, its roofline share and its ``mfu``
read the same work.

Counts are of what the work needs (``counts.py``'s rule): a convolution
over a kernel map is 2 · pairs · Cin · Cout bf16 operations (a pair: an
output voxel and an input voxel the map joins), whatever a kernel computes
for the offsets a voxel lacks; its bytes are each input row, the weights
and each output row once, in bf16. A 1x1 conv is 2 · rows · Cin · Cout.
BN, ECA, GeM and the ReLUs are left out, as ``counts.forward_flops`` leaves
out normalisations and activations.

Maps do not cross clouds, so a batch's work is the sum of its submaps';
``batch_work`` gives the mean over the pool for a batch of B submaps.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.reference import minkloc3dv2 as ref

BF16_BYTES = 2
CLOUDS = 8  # submaps counted at a time


def conv_shapes(model: dict) -> list[tuple[str, str, int, int, int]]:
    """(conv, its map, K, Cin, Cout) of every convolution over a kernel map
    in a forward, in order: conv0, each level's down conv and its block's two
    3³ convs, the transposed convs."""
    planes, width = model["proxyconv_channels"], model["lift_channels"][-1]
    out = [("conv0", "conv0", 125, 1, planes[0])]
    fan = planes[0]
    for i, plane in enumerate(planes):
        out.append((f"down_{i}", f"down_{i}", 8, fan, fan))
        out.append((f"block_{i}.conv1", f"block_{i}", 27, fan, plane))
        out.append((f"block_{i}.conv2", f"block_{i}", 27, plane, plane))
        fan = plane
    out += [(f"tconv_{j}", f"up_{j}", 8, width, width) for j in range(ref.TOP_DOWN)]
    return out


def dense_shapes(model: dict) -> list[tuple[str, int, int, int]]:
    """(1x1 conv, its stride, Cin, Cout): the residuals' where a block's
    width changes, then the laterals."""
    planes, width = model["proxyconv_channels"], model["lift_channels"][-1]
    out, fan = [], planes[0]
    for i, plane in enumerate(planes):
        if fan != plane:
            out.append((f"block_{i}.downsample", 2 ** (i + 1), fan, plane))
        fan = plane
    top = 2 ** len(planes)
    out.append(("conv1x1_0", top, planes[-1], width))
    out += [(f"conv1x1_{j + 1}", top // 2 ** (j + 1), planes[-2 - j], width)
            for j in range(ref.TOP_DOWN)]
    return out


def map_sizes(points: torch.Tensor) -> dict:
    """Pairs, input rows and output rows of each kernel map of the forward
    of ``points`` [B, N, 3], and the voxels at each stride."""
    vox = ref.Voxels(points)
    rows = {s: int(v.shape[0]) for s, v in vox.v.items()}
    out = {"conv0": {"pairs": int((ref.odd_table(vox.v[1], 1, 5) >= 0).sum()),
                     "rows_in": rows[1], "rows_out": rows[1]}}
    for i in range(len(ref.PLANES)):
        s = 2 ** i
        out[f"down_{i}"] = {"pairs": rows[s], "rows_in": rows[s], "rows_out": rows[2 * s]}
        out[f"block_{i}"] = {"pairs": int((ref.odd_table(vox.v[2 * s], 2 * s, 3) >= 0).sum()),
                             "rows_in": rows[2 * s], "rows_out": rows[2 * s]}
    top = 2 ** len(ref.PLANES)
    for j in range(ref.TOP_DOWN):
        s = top // 2 ** (j + 1)
        out[f"up_{j}"] = {"pairs": rows[s], "rows_in": rows[2 * s], "rows_out": rows[s]}
    return {"maps": out, "voxels": rows}


def conv_work(k: int, cin: int, cout: int, pairs: float, rows_in: float,
              rows_out: float) -> dict:
    """One convolution over a map: bf16 operations and bytes."""
    return {"bf16_flops": 2.0 * pairs * cin * cout,
            "bytes": BF16_BYTES * (rows_in * cin + k * cin * cout + rows_out * cout)}


@torch.no_grad()
def batch_work(model: dict, pool, batch: int, device) -> dict:
    """A batch's work, the pool's mean per submap times ``batch``:
    ``convs`` (each convolution over a map, in ``conv_shapes`` order, with
    its operations and bytes), ``dense`` (each 1x1 conv's operations), and
    ``voxels`` (at each stride) and ``pairs`` (each map's), per batch."""
    x = torch.as_tensor(np.asarray(pool), dtype=torch.float32, device=device)
    maps: dict = {}
    voxels: dict = {}
    for s0 in range(0, x.shape[0], CLOUDS):
        sizes = map_sizes(x[s0:s0 + CLOUDS])
        for name, m in sizes["maps"].items():
            acc = maps.setdefault(name, {"pairs": 0, "rows_in": 0, "rows_out": 0})
            for key in acc:
                acc[key] += m[key]
        for s, m in sizes["voxels"].items():
            voxels[s] = voxels.get(s, 0) + m
    scale = batch / x.shape[0]
    maps = {n: {k: v * scale for k, v in m.items()} for n, m in maps.items()}
    convs = [{"conv": name, **conv_work(k, cin, cout, **maps[mp])}
             for name, mp, k, cin, cout in conv_shapes(model)]
    dense = [{"conv": name, "bf16_flops": 2.0 * voxels[s] * scale * cin * cout}
             for name, s, cin, cout in dense_shapes(model)]
    return {"convs": convs, "dense": dense,
            "voxels": {s: v * scale for s, v in voxels.items()},
            "pairs": {n: m["pairs"] for n, m in maps.items()}}
