"""Operations and bytes of the work, from the configuration's shapes, and
the card's published peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W power limit; a card set below it runs slower, so every result states
the card's limit beside these shares): 989 TFLOP/s in bf16 on the tensor
cores, 67 TFLOP/s in fp32 outside them, 3.35 TB/s of HBM3.

Counts are of what the work needs, not of what a kernel or route does:
each input byte read once and each output byte written once; a neighbour
mean is N·k·C sums, however the program computes it (the dense route
multiplies by the whole N×N indicator, which these counts leave out, so a
route that stops doing so shows as a gain).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PUBLISHED_POWER_W = 700.0

# the kNN distance: 3 subtractions, 3 products and 2 sums a pair, fp32
KNN_OPS_PER_PAIR = 8


def k1_work(b: int, n: int) -> dict:
    """K1 (the dense kNN indicator and the layer-0 proxy) on B clouds of N
    points: fp32 operations and bytes (xyz read once as fp32, the int8
    [B, N, N] indicator and the bf16 [B, N, 3] proxy written once)."""
    return {"fp32_flops": KNN_OPS_PER_PAIR * b * n * n,
            "bytes": b * n * 3 * 4 + b * n * n + b * n * 3 * 2}


def least_seconds(work: dict) -> float:
    """The least time the card could take: the larger of the compute bound
    (bf16 and fp32 operations at their peaks, added) and the memory bound."""
    compute = (work.get("bf16_flops", 0) / PEAK_BF16_FLOPS
               + work.get("fp32_flops", 0) / PEAK_FP32_FLOPS)
    return max(compute, work.get("bytes", 0) / PEAK_HBM_BYTES)


def _dense(rows: int, fan_in: int, width: int) -> int:
    return 2 * rows * fan_in * width


def forward_flops(model: dict, n: int) -> dict:
    """Operations of one submap's forward at N points, by precision: the
    backbone's products in bf16 (ProxyConv Dense, lift, the VLAD
    assignment), the kNN distances, the neighbour sums, the VLAD's residual
    sums and the head in fp32. Normalisations, softmax and activations are
    left out."""
    k, chans = model["knn_k"], model["proxyconv_channels"]
    bf16 = fp32 = 0
    fp32 += KNN_OPS_PER_PAIR * n * n
    fan = 3
    for ch in chans:
        fp32 += n * k * fan  # the neighbour sums
        bf16 += _dense(n, 2 * fan, ch)
        fan = ch
    fan = sum(chans)
    for width in model["lift_channels"]:
        bf16 += _dense(n, fan, width)
        fan = width
    c, d, g = model["vlad_clusters"], model["feature_dim"], model["vlad_groups"]
    gd, out = model["vlad_group_dim"], model["output_dim"]
    bf16 += _dense(n, d, c)  # the assignment logits
    fp32 += 2 * c * n * d  # A^T X
    fp32 += 2 * c * d * gd  # the grouped FC: G groups of (C·D/G) x gd
    if not (g == 1 and gd == out):
        fp32 += _dense(1, g * gd, out)
    if model["gating"]:
        fp32 += _dense(1, out, out)
    return {"bf16_flops": bf16, "fp32_flops": fp32}


def param_count(model: dict) -> int:
    """Parameters of the model (BN statistics left out)."""
    from bench_h100.weights import is_statistic, leaves

    total = 0
    for key, shape, _ in leaves(model):
        if not is_statistic(key):
            size = 1
            for s in shape:
                size *= s
            total += size
    return total


def embed_batch_work(model: dict, b: int, n: int) -> dict:
    """B submaps' forward."""
    f = forward_flops(model, n)
    return {"bf16_flops": b * f["bf16_flops"], "fp32_flops": b * f["fp32_flops"]}


def train_step_work(model: dict, clouds: int, n: int) -> dict:
    """One training step on ``clouds`` submaps: the forward, and a backward
    of twice the forward's products (each product's two operand gradients;
    the kNN has none), plus Adam's ~12 fp32 operations a parameter."""
    f = forward_flops(model, n)
    knn = KNN_OPS_PER_PAIR * n * n
    return {"bf16_flops": 3 * clouds * f["bf16_flops"],
            "fp32_flops": clouds * (knn + 3 * (f["fp32_flops"] - knn))
            + 12 * param_count(model)}
