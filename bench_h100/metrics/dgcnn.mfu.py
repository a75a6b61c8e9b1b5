"""``dgcnn.mfu`` (%): a DGCNN-VLAD batch's least time at the card's
published peaks over the time a batch takes outside the traced stretch on
the host's clock (``Trace.unit_s``). The least time is
``counts.least_seconds`` of the forward's operations from the
configuration's shapes (``counts_graph.dgcnn_embed_batch_work``)."""

from bench_h100 import counts, counts_graph


def read(obs):
    t = obs.trace
    if t is None or not t.has_device or not t.unit_s:
        return None
    work = counts_graph.dgcnn_embed_batch_work(obs.model, obs.params["batch"],
                                               obs.model["num_points"])
    return 100.0 * counts.least_seconds(work) / t.unit_s
