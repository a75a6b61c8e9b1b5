"""``serve.collect_ms`` (ms): the host's time inside the scheduler's
``serve/collect`` spans (from a micro-batch's first request until it closes,
full or at ``max_wait_ms``), over the number of those spans in the traced
stretch."""

SPAN = "serve/collect"


def read(obs):
    t = obs.trace
    ms = [(end - start) / 1e3 for start, end, name in t.spans if name == SPAN] if t else []
    return sum(ms) / len(ms) if ms else None
