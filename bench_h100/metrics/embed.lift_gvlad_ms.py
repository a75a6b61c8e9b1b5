"""``embed.lift_gvlad_ms`` (ms): device time a batch of the lift and the
G-VLAD head (spans ``epcnet/lift``, ``epcnet/gvlad``)."""

SPANS = ("epcnet/lift", "epcnet/gvlad")


def read(obs):
    t = obs.trace
    if t is None or not t.has_device or not t.units:
        return None
    us = t.span_device_us(SPANS)
    return us / 1e3 / t.units if us else None
