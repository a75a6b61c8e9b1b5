"""``PreemptionGuard`` (twin of the class in
``epcnet_tpu/parallel/multislice.py``; the mesh functions there are ROADMAP
item 6, Multi-device)."""

from __future__ import annotations

import signal


class PreemptionGuard:
    """Turn SIGTERM/SIGINT into a cooperative stop flag.

    A preemption delivers SIGTERM with a grace window; the guard records the
    request and the Trainer (polling ``guard()`` after each dispatch) saves
    a checkpoint and returns instead of dying mid-step. The context manager
    restores the previous handlers on exit; the guard is also the
    ``should_stop`` callable itself.

    The SECOND signal aborts hard (KeyboardInterrupt): the flag is polled
    only between steps, so a run stuck before its first step (a kernel
    build) must stay interruptible: one Ctrl+C means "checkpoint then
    stop", two mean "stop now".
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._old: dict = {}
        self.requested = False

    def _handle(self, signum, frame):
        if self.requested:
            raise KeyboardInterrupt  # second signal: abort hard
        self.requested = True
        print("[preemption] will checkpoint after the in-flight step and stop; "
              "signal again to abort immediately", flush=True)

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> bool:
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()
        return False

    def __call__(self) -> bool:
        return self.requested
