"""``minkloc.k11_roofline`` (%): K11's least time over its device time. A
batch runs K11 once for each convolution over a kernel map (conv0, the
stride-2 convs, the blocks' 3³ convs, the transposed convs); the least
time of each is the larger of its operations at the bf16 peak and its
bytes at the card's bandwidth, counted from the pool by the benchmark's own
maps (``counts_sparse.batch_work``: 2 · pairs · Cin · Cout; each input row,
the weights and each output row once). The device time is every K11 kernel
record's (``sparse_conv_kernel``, ``sparse_conv_c1_kernel``) in the
stretch."""

from bench_h100 import counts

KERNELS = ("sparse_conv",)


def read(obs):
    t = obs.trace
    work = (obs.counters or {}).get("work")
    if t is None or not t.has_device or not t.units or not work:
        return None
    us, launches = t.kernel_us(KERNELS)
    if not launches or us <= 0:
        return None
    least = sum(counts.least_seconds(c) for c in work["convs"])
    return 100.0 * least * t.units / (us / 1e6)
