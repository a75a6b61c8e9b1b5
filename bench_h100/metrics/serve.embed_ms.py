"""``serve.embed_ms`` (ms): device time of the work launched inside the
model's spans (``epcnet/...``) a dispatch, over the traced stretch."""

SPANS = ("epcnet/knn_graph", "epcnet/indicator_cast", "epcnet/proxyconv_0",
         "epcnet/proxyconv_1", "epcnet/proxyconv_2", "epcnet/proxyconv_3",
         "epcnet/neighbor_mean", "epcnet/lift", "epcnet/gvlad")


def read(obs):
    t = obs.trace
    if t is None or not t.has_device or not t.units:
        return None
    us = t.span_device_us(SPANS)
    return us / 1e3 / t.units if us else None
