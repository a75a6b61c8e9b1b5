"""The system under test, ``epcnet_torch``, as the benchmark drives it: the
one module of the harness that imports the port (the reference never does).

- ``place_index``: a ``PlaceIndex`` over the port's embed
  (``build_embed_fn`` with the benchmark's weights, handed over by their
  flat names), or, for the control, over the reference put in the port's
  place at the control's precision;
- ``PortTrainer``: the port's training state and step
  (``create_train_state``, ``build_train_step``), with the readings the
  correctness check takes from it.
"""

from __future__ import annotations

import dataclasses

import torch

from bench_h100.reference import model as ref_model
from bench_h100.reference.precision import CONTROL
from bench_h100.weights import is_statistic, to_flat
from epcnet_torch.configs import ModelConfig, TrainConfig
from epcnet_torch.serve import PlaceIndex, QueryScheduler
from epcnet_torch.train.state import create_train_state
from epcnet_torch.train.step import build_embed_fn, build_train_step
from epcnet_torch.utils.compile_cache import enable_compilation_cache

__all__ = ["QueryScheduler", "PortTrainer", "enable_compilation_cache", "model_config",
           "place_index", "train_config"]


def model_config(model: dict) -> ModelConfig:
    """The port's ``ModelConfig`` of a configuration file's ``model``
    section (keys the port has no field for, such as the reference's BN
    epsilon, are left out)."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in model.items() if k in names})


def train_config(train: dict, tuples: int) -> TrainConfig:
    """The port's ``TrainConfig`` of a configuration file's ``train``
    section, with ``tuples`` tuples a step."""
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(batch_num_queries=tuples,
                       **{k: v for k, v in train.items() if k in names})


def place_index(model: dict, weights: dict, device, batch: int, max_k: int,
                control: bool = False) -> PlaceIndex:
    """A fp32 ``PlaceIndex`` embedding ``batch`` submaps at a time."""
    if control:
        def embed(points: torch.Tensor) -> torch.Tensor:
            return ref_model.embed(weights, model, points, device, p=CONTROL)
    else:
        embed = build_embed_fn(model_config(model), device, variables=to_flat(weights))
    return PlaceIndex(embed, model["output_dim"], embed_batch=batch, max_k=max_k,
                      num_points=model["num_points"], device=device)


class PortTrainer:
    """The port's training object: one state, stepped in place."""

    def __init__(self, model: dict, train: dict, weights: dict, device, tuples: int):
        mcfg, tcfg = model_config(model), train_config(train, tuples)
        self.state = create_train_state(mcfg, tcfg, device, variables=to_flat(weights))
        self._step = build_train_step(mcfg, tcfg)
        self.losses: list = []

    def step(self, batch: dict) -> None:
        self.state, m = self._step(self.state, batch)
        self.losses.append(m["loss"])

    def _moments(self, which: str) -> dict:
        """Adam's ``exp_avg`` or ``exp_avg_sq`` by leaf name, as the
        optimiser holds them (zeros for a leaf it never updated)."""
        st = self.state.optimizer.state
        return {k: st[p][which] if which in st.get(p, {}) else torch.zeros_like(p)
                for k, p in self.state.model.named_parameters()}

    def first_moments(self) -> dict:
        return self._moments("exp_avg")

    def leaves(self) -> dict:
        """Parameters and BN statistics by leaf name."""
        m = self.state.model
        out = {k: p.detach() for k, p in m.named_parameters()}
        out.update({k: b for k, b in m.named_buffers() if is_statistic(k)})
        return out

    def snapshot(self) -> dict:
        """Copies of ``leaves`` and of Adam's moments (``m1``, ``m2``)."""
        with torch.no_grad():
            return {"leaves": {k: v.clone() for k, v in self.leaves().items()},
                    "m1": {k: v.clone() for k, v in self._moments("exp_avg").items()},
                    "m2": {k: v.clone() for k, v in self._moments("exp_avg_sq").items()}}
