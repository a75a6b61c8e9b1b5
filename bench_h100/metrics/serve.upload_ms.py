"""``serve.upload_ms`` (ms): the host's time a dispatch in the scheduler's
``serve/stack`` span (grouping and ``np.stack``) plus the index's
``serve/upload`` span (padding and the copy to the card), each the mean over
its own spans in the traced stretch, so that a dispatch whose stack came
before the profiler started counts right."""

SPANS = ("serve/stack", "serve/upload")


def read(obs):
    t = obs.trace
    if t is None:
        return None
    total = 0.0
    for span in SPANS:
        ms = [(end - start) / 1e3 for start, end, name in t.spans if name == span]
        if not ms:
            return None
        total += sum(ms) / len(ms)
    return total
