"""``dgcnn.k8_roofline`` (%): K8's least time over its device time. A
batch of B clouds of N points runs K8 once a layer past the first, on
that layer's input (D = the previous layer's width); the least time of one
launch is the larger of its operations at the peaks (2·D bf16 a pair on
the tensor cores, plus the fp32 subtraction a pair and the norms) and its
bytes at the card's bandwidth (the features read once, the ids written
once; ``counts_graph.k8_work``). The device time is every K8 kernel record's
(``knn_features_norms_kernel`` and ``knn_features_tiled_kernel``) in the
stretch."""

from bench_h100 import counts, counts_graph

KERNELS = ("knn_features",)


def read(obs):
    t = obs.trace
    if t is None or not t.has_device or not t.units:
        return None
    us, launches = t.kernel_us(KERNELS)
    if not launches or us <= 0:
        return None
    m, b = obs.model, obs.params["batch"]
    least = sum(counts.least_seconds(counts_graph.k8_work(b, m["num_points"], d, m["knn_k"]))
                for d in m["proxyconv_channels"][:-1])
    return 100.0 * least * t.units / (us / 1e6)
