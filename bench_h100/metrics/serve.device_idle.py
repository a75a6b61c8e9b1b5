"""``serve.device_idle`` (%): the share of a dispatch's time in which nothing
runs on the card: 1 - (the union of the device's activity intervals in the
traced stretch, a dispatch) / (the time a dispatch takes outside the stretch, on
the host's clock, where the profiler does not slow the host;
``Trace.idle_share``)."""


def read(obs):
    t = obs.trace
    share = t.idle_share() if t is not None else None
    return None if share is None else 100.0 * share
