"""``dgcnn.knn_ms`` (ms): device time a batch of DGCNN-VLAD's four kNN
graphs, layer 0's on xyz (K2) and layers 1-3's in feature space (K8)
(spans ``dgcnn/knn_0`` .. ``dgcnn/knn_3``)."""

SPANS = tuple(f"dgcnn/knn_{i}" for i in range(4))


def read(obs):
    t = obs.trace
    if t is None or not t.has_device or not t.units:
        return None
    us = t.span_device_us(SPANS)
    return us / 1e3 / t.units if us else None
