"""``train.backward_ms`` (ms): device time a step of the work launched
inside the train step's ``train/backward`` span."""


def read(obs):
    t = obs.trace
    if t is None or not t.has_device or not t.units:
        return None
    us = t.span_device_us(("train/backward",))
    return us / 1e3 / t.units if us else None
