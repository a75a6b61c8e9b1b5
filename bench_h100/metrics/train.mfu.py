"""``train.mfu`` (%): the step's least time at the card's published peaks
over the time a step takes outside the traced stretch on the host's
clock (``Trace.unit_s``; the profiler slows the host inside it). The
least time is ``counts.least_seconds`` of the step's operations from the
configuration's shapes (``counts.train_step_work``: forward, backward and
Adam)."""

from bench_h100 import counts


def read(obs):
    t = obs.trace
    if t is None or not t.has_device or not t.unit_s:
        return None
    work = counts.train_step_work(obs.model, obs.counters["clouds_per_step"],
                                  obs.model["num_points"])
    return 100.0 * counts.least_seconds(work) / t.unit_s
