"""``dgcnn.edgeconv_ms`` (ms): device time a batch of DGCNN-VLAD's four
EdgeConv layers: the gather of the neighbours, the [B, N, k, 2C] edges,
the Dense, BN, LeakyReLU and the max over k (spans ``dgcnn/edgeconv_0`` ..
``dgcnn/edgeconv_3``)."""

SPANS = tuple(f"dgcnn/edgeconv_{i}" for i in range(4))


def read(obs):
    t = obs.trace
    if t is None or not t.has_device or not t.units:
        return None
    us = t.span_device_us(SPANS)
    return us / 1e3 / t.units if us else None
