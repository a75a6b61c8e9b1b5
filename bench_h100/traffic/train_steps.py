"""Training steps: one training object (the port's state and step), driven
from the seed through its first three steps in set-up, on three batches
whose clouds all differ, then stepped through the window on host batches
from a seeded pool. The feed copies each batch to the card from pinned
memory without waiting for the card, as a loader with ``pin_memory``
does, so the host dispatches the next step while the card runs this one
(a pageable copy would wait for the card at every step). The
window's last step starts once ``--seconds`` have passed; its state before
that step (parameters, BN statistics, Adam's moments) is copied. That step
takes one more seeded batch, from outside the pool: within a window the
object learns the pool's few batches until their loss, and so their
gradient, is nought, which would leave the step nothing to judge.

A batch is ``tuples`` tuples of 1 query, ``positives``, ``negatives`` and
the other negative, of blob submaps (``data.tuple_batch``).

End to end: ``train_step_ms``, the window's time over the steps completed
in it (the card synchronised at its close).

Correctness: the reference follows the same three steps from the same
weights on the same batches, once the window has closed. Each of these is
a gap between the program's reading and the reference's, relative to the
reference's (a norm's gap by the worst leaf, against the larger of that
leaf's reference norm and the median leaf's):

- ``loss_gap``: each step's loss;
- ``grad_gap``: the norm of the first gradient, as Adam holds it after the
  first step (its first moment over 1 - b1);
- ``change_gap``: the norm of each parameter's change over the three
  steps; leaves whose reference gradient is under a thousandth of the
  median leaf's (a bias before BN, which BN cancels) move by rounding
  alone and are left out;
- ``bn_gap``: the norm of each BN running statistic's change.

The window's last step is held the same way: the reference takes one step
from the program's copied state, at the step count the harness drove, on
the same batch; ``last_change_gap`` and ``last_bn_gap`` are the gaps of
that step's changes (with ``_median`` the median leaf's, ``last_loss_gap``
its loss). The reference follows the program's state here, which the first
three steps check from the seed's weights.

Parameters: ``tuples``, ``positives``, ``negatives``, ``pool`` (batches),
``trace_skip`` and ``trace_units`` (the traced steps).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import data, program
from bench_h100.reference.precision import CONTROL
from bench_h100.reference.train import Trainer
from bench_h100.trace import Stretch
from bench_h100.weights import is_statistic, make_weights

FIRST_STEPS = 3


def _norms(tensors: dict, minus: dict | None = None, scale: float = 1.0) -> dict:
    with torch.no_grad():
        return {k: float(torch.linalg.vector_norm(
            (v.float() - minus[k].float()) if minus is not None else v.float()) * scale)
            for k, v in tensors.items()}


def changes(trainer, start: dict) -> dict:
    """The norms of each parameter's (``change``) and BN statistic's
    (``bn``) change from ``start`` to the training object's state."""
    leaves = trainer.leaves()
    return {"change": _norms({k: v for k, v in leaves.items() if not is_statistic(k)},
                             start),
            "bn": _norms({k: v for k, v in leaves.items() if is_statistic(k)}, start)}


def readings(trainer, weights: dict) -> dict:
    """A training object's readings after its first three steps (the first
    gradient's norms are taken after the first step, by ``_first_steps``)."""
    return {"loss": [float(x) for x in trainer.losses[:FIRST_STEPS]],
            **changes(trainer, weights)}


def _rel(gap: float, ref: float) -> float:
    """``gap`` relative to ``ref``; a gap against a reading of nought is
    nought when the program's is nought too, else infinite."""
    return gap / ref if ref else (0.0 if gap == 0 else float("inf"))


def _gaps(prog: dict, ref: dict, keys) -> list[float]:
    """Each leaf's gap of norms, against the larger of its reference norm
    and the median leaf's."""
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    return [_rel(abs(prog[k] - ref[k]), max(ref[k], med)) for k in keys]


def _moved(grad: dict) -> list[str]:
    """Leaves whose reference gradient norm is at least a thousandth of the
    median leaf's (the others move by rounding alone)."""
    med = float(np.median(list(grad.values())))
    return [k for k, g in grad.items() if g >= 1e-3 * med]


def compare(prog: dict, ref: dict) -> dict:
    """The four gaps of the module docstring."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    moved = _moved(ref["grad"])
    grad = _gaps(prog["grad"], ref["grad"], ref["grad"])
    change = _gaps(prog["change"], ref["change"], moved)
    bn = _gaps(prog["bn"], ref["bn"], ref["bn"])
    return {"loss_gap": loss, "grad_gap": max(grad), "change_gap": max(change),
            "bn_gap": max(bn), "grad_gap_median": float(np.median(grad)),
            "change_gap_median": float(np.median(change)),
            "bn_gap_median": float(np.median(bn))}


def compare_last(prog: dict, ref: dict) -> dict:
    """The gaps of the window's last step (the module docstring)."""
    change = _gaps(prog["change"], ref["change"], _moved(ref["grad"]))
    bn = _gaps(prog["bn"], ref["bn"], ref["bn"])
    return {"last_loss_gap": _rel(abs(prog["loss"] - ref["loss"]), abs(ref["loss"])),
            "last_change_gap": max(change), "last_bn_gap": max(bn),
            "last_change_gap_median": float(np.median(change)),
            "last_bn_gap_median": float(np.median(bn))}


class Kind:
    def __init__(self, model: dict, train: dict, params: dict, device, seed: int,
                 control: bool = False):
        self.model, self.train, self.params = model, train, params
        self.device, self.seed, self.control = device, seed, control
        self.counters: dict = {}

    def _trainer(self, control: bool):
        if control:
            return Trainer(self.weights, self.model, self.train, self.device, CONTROL)
        return program.PortTrainer(self.model, self.train, self.weights, self.device,
                                   self.params["tuples"])

    def _feed(self, batch: dict) -> dict:
        """The batch on the card, copied from pinned memory without waiting."""
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    def _host_batch(self, r) -> dict:
        """A seeded batch as contiguous host tensors, pinned where a card takes them."""
        p = self.params
        b = data.tuple_batch(r, p["tuples"], p["positives"], p["negatives"],
                             self.model["num_points"])
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
        if torch.device(self.device).type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _first_steps(self, trainer) -> dict:
        b1 = self.train["adam_b1"]
        trainer.step(self._feed(self.batches[0]))
        grad = _norms(trainer.first_moments(), scale=1.0 / (1.0 - b1))
        for i in range(1, FIRST_STEPS):
            trainer.step(self._feed(self.batches[i]))
        return {**readings(trainer, self.weights), "grad": grad}

    def setup(self) -> None:
        p, lap = self.params, data.Laps()
        self.weights = make_weights(self.model, data.torch_seed(self.seed, "weights"),
                                    self.device)
        r = data.rng(self.seed, "batches")
        self.batches = [self._host_batch(r) for _ in range(p["pool"] + 1)]
        self.unseen = self.batches.pop()
        lap("inputs")
        self.trainer = self._trainer(self.control)
        lap("build")
        self.readings = self._first_steps(self.trainer)
        lap("first_steps")
        self.info = {"setup_laps_s": lap.laps}

    def window(self, seconds: float, trace: bool) -> dict:
        p = self.params
        stretch = Stretch(self.device, p["trace_skip"], p["trace_units"]) if trace else None
        steps = 0
        t0 = time.perf_counter()
        while True:
            batch = self.batches[(FIRST_STEPS + steps) % len(self.batches)]
            last = time.perf_counter() - t0 >= seconds
            if last:  # the reference repeats this step from this state
                batch = self.unseen
                self.last = {"state": self.trainer.snapshot(), "batch": batch,
                             "steps": FIRST_STEPS + steps}
            if stretch:
                stretch.before(steps)
            self.trainer.step(self._feed(batch))
            if stretch:
                stretch.after(steps)
            steps += 1
            if last:
                break
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        if stretch:
            stretch.finish(steps, t0, t1)
        self.trace = stretch.trace if stretch else None
        self.last_readings = {"loss": float(self.trainer.losses[-1]),
                              **changes(self.trainer, self.last["state"]["leaves"])}
        self.info["losses"] = {"pool_before_last": float(self.trainer.losses[-2]),
                               "unseen_last": self.last_readings["loss"]}
        self.attempted, self.failed = steps, 0
        self.counters = {"clouds_per_step": p["tuples"] * (p["positives"] + p["negatives"] + 2)}
        return {"train_step_ms": (t1 - t0) / steps * 1e3}

    def free(self) -> None:
        self.trainer = None

    def check(self) -> dict:
        ref = Trainer(self.weights, self.model, self.train, self.device)
        numbers = compare(self.readings, self._first_steps(ref))
        last = self.last
        ref = Trainer.resume(last["state"], last["steps"], self.model, self.train, self.device)
        ref.step(last["batch"])
        ref_last = {"loss": ref.losses[-1], "grad": _norms(ref.grads),
                    **changes(ref, last["state"]["leaves"])}
        return {**numbers, **compare_last(self.last_readings, ref_last)}
