"""Compute ops of the port. Each hand-written CUDA kernel (``csrc/``) has a
plain PyTorch twin in the same module: a CPU tensor takes the twin, a CUDA
tensor the kernel, with no fallback between them."""

from epcnet_torch.ops.adjacency import (
    count_adjacency,
    gather_neighbor_mean,
    mean_adjacency,
    neighbor_mean,
    pack_indicator,
    packed_neighbor_mean,
    unpack_indicator,
)
# the kNN-ids dispatcher stays ``epcnet_torch.ops.knn.knn``: exported here it
# would shadow the submodule ``epcnet_torch.ops.knn`` that callers import
from epcnet_torch.ops.knn import knn_adjacency, knn_adjacency_plain, knn_cuda, knn_plain
from epcnet_torch.ops.pairwise import pairwise_sqdist
from epcnet_torch.ops.retrieval import (
    dequantize_descriptors,
    l2_distance_matrix,
    quantize_descriptors,
    quantized_distance_matrix,
    ring_knn_points,
    ring_topk_neighbors,
    sharded_topk_neighbors,
    topk_neighbors,
    topk_neighbors_quantized,
)
from epcnet_torch.ops.sampling import (
    ball_query,
    farthest_point_sample,
    gather_point,
    group_point,
    prob_sample,
    three_interpolate,
    three_nn,
)
from epcnet_torch.ops.vlad import vlad_aggregate

__all__ = [
    "pairwise_sqdist",
    "knn_plain",
    "knn_cuda",
    "knn_adjacency",
    "knn_adjacency_plain",
    "count_adjacency",
    "mean_adjacency",
    "neighbor_mean",
    "pack_indicator",
    "unpack_indicator",
    "packed_neighbor_mean",
    "gather_neighbor_mean",
    "vlad_aggregate",
    "farthest_point_sample",
    "gather_point",
    "prob_sample",
    "ball_query",
    "group_point",
    "three_nn",
    "three_interpolate",
    "l2_distance_matrix",
    "topk_neighbors",
    "sharded_topk_neighbors",
    "ring_topk_neighbors",
    "ring_knn_points",
    "quantize_descriptors",
    "dequantize_descriptors",
    "quantized_distance_matrix",
    "topk_neighbors_quantized",
]
