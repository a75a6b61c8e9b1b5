"""``embed.k1_roofline`` (%): K1's least time over its device time. The
least time of one launch on a batch of B clouds of N points is the larger
of its bytes at the card's bandwidth and its operations at the fp32 peak
(``counts.k1_work``: xyz read once, the int8 [B, N, N] indicator and the
proxy written once, 8 operations a pair); the device time is K1's kernel
records' (``knn_dense_tiled_kernel``, or ``knn_adj_kernel`` past k = 32)."""

from bench_h100 import counts

KERNELS = ("knn_dense_tiled_kernel", "knn_adj_kernel")


def read(obs):
    t = obs.trace
    if t is None or not t.has_device:
        return None
    us, launches = t.kernel_us(KERNELS)
    if not launches or us <= 0:
        return None
    least = counts.least_seconds(counts.k1_work(obs.params["batch"], obs.model["num_points"]))
    return 100.0 * least * launches / (us / 1e6)
