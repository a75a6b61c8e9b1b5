"""``embed.adjacency_ms`` (ms): device time a batch of the work on the
N x N indicator: the kNN graph (K1), its int8 -> bf16 cast and the
neighbour means ``A @ F`` (spans ``epcnet/knn_graph``,
``epcnet/indicator_cast``, ``epcnet/neighbor_mean``)."""

SPANS = ("epcnet/knn_graph", "epcnet/indicator_cast", "epcnet/neighbor_mean")


def read(obs):
    t = obs.trace
    if t is None or not t.has_device or not t.units:
        return None
    us = t.span_device_us(SPANS)
    return us / 1e3 / t.units if us else None
