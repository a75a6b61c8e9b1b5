"""Operations and bytes of the graph work the embed cells do outside
EPC-Net's dense route: K2's xyz kNN ids, K8's feature-space kNN ids, and
DGCNN-VLAD's forward, at the peaks of ``counts.py``.

Counts are of what the work needs (``counts.py``'s rule): each input byte
read once and each output byte written once, however a kernel reads them.
"""

from __future__ import annotations

from bench_h100.counts import KNN_OPS_PER_PAIR

ID_BYTES = 4  # an int32 id


def k2_work(b: int, n: int, k: int) -> dict:
    """K2 (the k nearest ids on xyz) on B clouds of N points: 8 fp32
    operations a pair; xyz read once as fp32, the int32 ids written once."""
    return {"fp32_flops": KNN_OPS_PER_PAIR * b * n * n,
            "bytes": b * n * 3 * 4 + b * n * k * ID_BYTES}


def k8_work(b: int, n: int, d: int, k: int) -> dict:
    """K8 (the k nearest ids in feature space) on B clouds of N points of D
    bf16 features: the inner products, 2·D bf16 operations a pair on the
    tensor cores, plus the fp32 subtraction from the candidate's norm a
    pair and the norms (2·D a point); the features read once, the ids
    written once."""
    return {"bf16_flops": 2 * d * b * n * n,
            "fp32_flops": b * n * n + 2 * b * n * d,
            "bytes": b * n * d * 2 + b * n * k * ID_BYTES}


def dgcnn_forward_flops(model: dict, n: int) -> dict:
    """Operations of one DGCNN-VLAD submap's forward at N points, by
    precision. bf16 (tensor cores): each EdgeConv's Dense on N·k edges of
    2·C_in -> C_i, the inner products of layers 1..'s kNN (2·C_in a pair),
    conv5, the VLAD assignment. fp32: layer 0's kNN (8 a pair), the
    subtraction a pair of layers 1..'s kNN, the VLAD's residual sums, the
    FC and the gate. BN, the activations, the max and the softmax are left
    out, as in ``counts.forward_flops``."""
    k, chans = model["knn_k"], model["proxyconv_channels"]
    bf16 = fp32 = 0
    fan = 3
    for i, ch in enumerate(chans):
        if i == 0:
            fp32 += KNN_OPS_PER_PAIR * n * n
        else:
            bf16 += 2 * fan * n * n
            fp32 += n * n + 2 * n * fan
        bf16 += 2 * n * k * 2 * fan * ch
        fan = ch
    fan = sum(chans)
    for width in model["lift_channels"]:
        bf16 += 2 * n * fan * width
        fan = width
    c, d, gd, out = (model["vlad_clusters"], model["feature_dim"], model["vlad_group_dim"],
                     model["output_dim"])
    bf16 += 2 * n * d * c  # the assignment logits
    fp32 += 2 * c * n * d  # A^T X
    fp32 += 2 * c * d * gd  # the FC
    if model["gating"]:
        fp32 += 2 * out * out
    return {"bf16_flops": bf16, "fp32_flops": fp32}


def dgcnn_embed_batch_work(model: dict, b: int, n: int) -> dict:
    """B submaps' forward."""
    f = dgcnn_forward_flops(model, n)
    return {"bf16_flops": b * f["bf16_flops"], "fp32_flops": b * f["fp32_flops"]}
