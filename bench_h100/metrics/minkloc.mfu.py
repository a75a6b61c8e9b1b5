"""``minkloc.mfu`` (%): a MinkLoc3Dv2 batch's least time at the card's
published peaks over the time a batch takes outside the traced stretch on
the host's clock (``Trace.unit_s``). The least time is ``counts.least_seconds``
of the operations the forward performs, counted from the pool by the
benchmark's own maps (``counts_sparse.batch_work``): each convolution's
2 · pairs · Cin · Cout over the pairs that exist, not over every offset of
its kernel, and each 1x1 conv's, in bf16."""

from bench_h100 import counts


def read(obs):
    t = obs.trace
    work = (obs.counters or {}).get("work")
    if t is None or not t.has_device or not t.unit_s or not work:
        return None
    flops = sum(c["bf16_flops"] for c in work["convs"] + work["dense"])
    return 100.0 * counts.least_seconds({"bf16_flops": flops}) / t.unit_s
