"""``embed.k2_roofline`` (%): K2's least time over its device time. The
least time of one launch on a batch of B clouds of N points is the larger
of its operations at the fp32 peak (8 a pair) and its bytes at the card's
bandwidth (xyz read once, the int32 ids written once;
``counts_graph.k2_work``); the device time is K2's kernel records'
(``knn_ids_tiled_kernel``, or ``knn_ids_rounds_kernel`` past k = 32)."""

from bench_h100 import counts, counts_graph

KERNELS = ("knn_ids_tiled_kernel", "knn_ids_rounds_kernel")


def read(obs):
    t = obs.trace
    if t is None or not t.has_device:
        return None
    us, launches = t.kernel_us(KERNELS)
    if not launches or us <= 0:
        return None
    m = obs.model
    least = counts.least_seconds(counts_graph.k2_work(obs.params["batch"], m["num_points"],
                                                      m["knn_k"]))
    return 100.0 * least * launches / (us / 1e6)
