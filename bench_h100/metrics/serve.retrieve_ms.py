"""``serve.retrieve_ms`` (ms): device time of the work launched inside the
index's ``serve/retrieve`` spans (the blocked top-k over the DB), over the
number of those spans in the traced stretch."""

SPAN = "serve/retrieve"


def read(obs):
    t = obs.trace
    if t is None or not t.has_device:
        return None
    n = sum(name == SPAN for _, _, name in t.spans)
    us = t.span_device_us((SPAN,)) if n else 0.0
    return us / 1e3 / n if us else None
