"""``serve.batch_fill`` (%): the scheduler's micro-batches' fill over the
window, requests a dispatch over ``max_batch``, from the deltas of
``QueryScheduler.metrics()``'s counters. Every dispatch embeds a batch
padded to ``max_batch``, so the rest is padding."""


def read(obs):
    c = obs.counters
    if not c.get("dispatches"):
        return None
    return 100.0 * c["requests"] / c["dispatches"] / c["max_batch"]
