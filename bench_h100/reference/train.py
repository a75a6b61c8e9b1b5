"""The training step, plainly: one train-mode forward of every cloud of the
batch's tuples (BN's statistics span them all), the lazy quadruplet loss
[PointNetVLAD's train.py; arXiv:2101.02374 §III-E], its gradient, BN's
running update and Adam.

- Clouds are flattened tuple by tuple: query, positives, negatives, the
  other negative.
- Loss: with d(a, b) the squared L2 distance of descriptors, best_pos the
  least d(q, p) over positives, the mean over tuples of
  max_j [m1 + best_pos - d(q, n_j)]_+ plus that of
  max_j [m2 + best_pos - d(o, n_j)]_+ (o the other negative).
- BN: running = m x running + (1 - m) x batch, with
  m = min(clip, 1 - init x rate^floor(step / steps)).
- Adam: m1 = b1 m1 + (1 - b1) g, m2 = b2 m2 + (1 - b2) g², then
  p -= lr / (1 - b1^t) x m1 / (sqrt(m2 / (1 - b2^t)) + eps), with
  lr = max(lr0 x rate^floor(step / steps), 1e-5) at the step before it.
"""

from __future__ import annotations

import math

import torch

from bench_h100.reference import model as ref_model
from bench_h100.reference.precision import FULL, Precision
from bench_h100.weights import is_statistic


def flatten(batch: dict, device) -> tuple[torch.Tensor, int, int, int]:
    """Tuples -> [B·T, N, 3] clouds; returns (clouds, B, P, Ng)."""
    t = {k: torch.as_tensor(batch[k], dtype=torch.float32, device=device)
         for k in ("query", "positives", "negatives", "other_neg")}
    b, p, n, _ = t["positives"].shape
    clouds = torch.cat([t["query"][:, None], t["positives"], t["negatives"],
                        t["other_neg"][:, None]], dim=1)
    return clouds.reshape(-1, n, 3), b, p, t["negatives"].shape[1]


def lazy_quadruplet(desc: torch.Tensor, b: int, p: int, ng: int, m1: float, m2: float):
    desc = desc.reshape(b, -1, desc.shape[-1])
    q, pos, neg, other = desc[:, 0], desc[:, 1:1 + p], desc[:, 1 + p:1 + p + ng], desc[:, -1]
    best_pos = ((pos - q[:, None]) ** 2).sum(-1).amin(-1)
    h1 = torch.clamp_min(m1 + best_pos[:, None] - ((neg - q[:, None]) ** 2).sum(-1), 0.0)
    h2 = torch.clamp_min(m2 + best_pos[:, None] - ((neg - other[:, None]) ** 2).sum(-1), 0.0)
    return h1.amax(-1).mean() + h2.amax(-1).mean()


class Trainer:
    """The reference's training object: parameters, BN statistics and
    Adam's moments, all fp32 on ``device``, from ``weights`` (copied)."""

    def __init__(self, weights: dict, model: dict, train: dict, device,
                 precision: Precision = FULL):
        self.model, self.cfg, self.p, self.device = model, train, precision, device
        self.params = {k: v.detach().clone().to(device).requires_grad_(True)
                       for k, v in weights.items() if not is_statistic(k)}
        self.stats = {k: v.detach().clone().to(device) for k, v in weights.items()
                      if is_statistic(k)}
        self.m1 = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.m2 = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.losses: list[float] = []
        self.grads: dict = {}

    @classmethod
    def resume(cls, snap: dict, steps: int, model: dict, train: dict, device,
               precision: Precision = FULL) -> "Trainer":
        """A training object at ``snap`` (``snapshot``'s form) after
        ``steps`` steps."""
        tr = cls({k: v.float() for k, v in snap["leaves"].items()}, model, train, device,
                 precision)
        tr.m1 = {k: v.detach().float().clone() for k, v in snap["m1"].items()}
        tr.m2 = {k: v.detach().float().clone() for k, v in snap["m2"].items()}
        tr.t = steps
        return tr

    def _schedules(self, step: int) -> tuple[float, float]:
        c = self.cfg
        lr = max(c["learning_rate"] * c["lr_decay_rate"] ** math.floor(step / c["lr_decay_steps"]),
                 1e-5)
        mom = min(c["bn_decay_clip"],
                  1.0 - c["bn_init_decay"] * c["bn_decay_rate"] ** math.floor(
                      step / c["bn_decay_steps"]))
        return lr, mom

    def step(self, batch: dict) -> None:
        c = self.cfg
        lr, mom = self._schedules(self.t)
        clouds, b, p, ng = flatten(batch, self.device)
        w = {**self.params, **self.stats}
        batch_stats: dict = {}
        desc = ref_model.forward(w, self.model, clouds, train=True, stats=batch_stats, p=self.p)
        loss = lazy_quadruplet(desc, b, p, ng, c["margin_1"], c["margin_2"])
        keys = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in keys])
        self.losses.append(float(loss.detach()))
        self.grads = dict(zip(keys, grads))
        with torch.no_grad():
            for bn, (mean, var) in batch_stats.items():
                for leaf, val in (("mean", mean), ("var", var)):
                    s = self.stats[f"{bn}.{leaf}"]
                    s.mul_(mom).add_(val, alpha=1.0 - mom)
            self.t += 1
            b1, b2, eps = c["adam_b1"], c["adam_b2"], c["adam_eps"]
            for k, g in zip(keys, grads):
                self.m1[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.m2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (self.m2[k] / (1.0 - b2 ** self.t)).sqrt_().add_(eps)
                self.params[k].addcdiv_(self.m1[k], denom, value=-lr / (1.0 - b1 ** self.t))

    def first_moments(self) -> dict:
        """Adam's first moments as they stand (after one step: (1 - b1) x
        the first gradient)."""
        return self.m1

    def leaves(self) -> dict:
        """Parameters and BN statistics as they stand."""
        return {**{k: v.detach() for k, v in self.params.items()}, **self.stats}

    def snapshot(self) -> dict:
        """Copies of ``leaves`` and of Adam's moments (``m1``, ``m2``)."""
        with torch.no_grad():
            return {"leaves": {k: v.clone() for k, v in self.leaves().items()},
                    "m1": {k: v.clone() for k, v in self.m1.items()},
                    "m2": {k: v.clone() for k, v in self.m2.items()}}
