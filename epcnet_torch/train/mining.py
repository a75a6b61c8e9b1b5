"""Hard-negative mining cache (twin of ``epcnet_tpu/train/mining.py``).

A periodic embedding sweep of the whole training set with the training
model's current weights (eval mode, running BN statistics); the [n, D]
latents then give each query its hardest negatives, computed once per sweep
in one batched pass on the model's device and read by the loader's threads.
"""

from __future__ import annotations

import numpy as np
import torch

from epcnet_torch.configs import DataConfig, TrainConfig
from epcnet_torch.data.loader import TupleLoader
from epcnet_torch.data.native_loader import load_pc_files_native
from epcnet_torch.data.tuples import TrainingTuples
from epcnet_torch.train.step import model_embed_fn


def _hardest_chunk(lat: torch.Tensor, idx_chunk: torch.Tensor, q_chunk: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Hardest-negative rows for one chunk of tuples: the k candidates of
    least squared latent distance, -1 where the pool (padded with -1) is
    shorter than k. Equal distances keep the pool's order and padding
    (+inf) comes last, as ``jax.lax.top_k(-d, k)`` orders them: a stable
    sort then the first k (``torch.topk`` promises no order among ties)."""
    cand = lat[idx_chunk.clamp_min(0)]  # [c, cap, D]
    qv = lat[q_chunk][:, None, :]  # [c, 1, D]
    d = torch.sum((cand - qv) ** 2, dim=-1)  # [c, cap]
    d = torch.where(idx_chunk < 0, torch.inf, d)
    pos = torch.sort(d, dim=-1, stable=True).indices[:, :k]
    sel = torch.take_along_dim(idx_chunk, pos, dim=-1)
    return torch.where(torch.take_along_dim(idx_chunk >= 0, pos, dim=-1), sel, -1)


class MiningCache:
    """Latent-vector cache + hardest-negative sampler."""

    def __init__(self, tuples: TrainingTuples, data_cfg: DataConfig,
                 train_cfg: TrainConfig, batch_size: int = 64):
        self.tuples = tuples
        self.data_cfg = data_cfg
        self.train_cfg = train_cfg
        self.batch_size = batch_size
        # (latents, generation) swapped as ONE tuple, so a reader can never
        # pair one refresh's latents with another's RNG keying
        self._cache: tuple[np.ndarray, int] | None = None
        # (hardest negatives [n, k] -1-padded, generation)
        self._hard: tuple[np.ndarray, int] | None = None

    def refresh(self, model: torch.nn.Module) -> None:
        """Re-embed every training submap with ``model`` as it stands, in
        batches of ``batch_size`` (the tail zero-padded, which running-stat
        BN cannot see), on the model's device; the latents reach the host in
        one copy at the end."""
        embed = model_embed_fn(model)
        n = len(self.tuples.queries)
        bs = self.batch_size
        chunks = []
        for s in range(0, n, bs):
            ids = range(s, min(s + bs, n))
            buf = np.zeros((bs, self.data_cfg.num_points, 3), np.float32)
            load_pc_files_native([self.tuples.queries[i]["query"] for i in ids],
                                 self.data_cfg.dataset_root, self.data_cfg.num_points,
                                 out=buf[:len(ids)], n_threads=self.data_cfg.loader_threads)
            chunks.append(embed(buf)[:len(ids)])
        lat_dev = torch.cat(chunks)
        gen = 0 if self._cache is None else self._cache[1] + 1
        self._hard = (self._precompute_hard_negatives(lat_dev, gen), gen)
        self._cache = (lat_dev.cpu().numpy(), gen)

    @property
    def latents(self) -> np.ndarray | None:
        return self._cache[0] if self._cache is not None else None

    def _precompute_hard_negatives(self, lat, generation: int) -> np.ndarray:
        """Hardest negatives for EVERY tuple, in chunks of 4096 tuples on
        ``lat``'s device. Pools longer than ``sampled_neg_pool`` are
        subsampled on the host, keyed (seed, 17, generation, query) as in
        JAX. Returns [n, min(hard_neg_per_tuple, pool width)] int64,
        -1-padded for short pools."""
        lat = torch.as_tensor(lat)
        n = len(self.tuples.queries)
        cap = self.train_cfg.sampled_neg_pool
        k = self.train_cfg.hard_neg_per_tuple
        widest = max((len(self.tuples.queries[i]["negatives"]) for i in range(n)), default=1)
        pools = np.full((n, max(1, min(cap, widest))), -1, np.int64)
        for qi in range(n):
            pool = self.tuples.queries[qi]["negatives"]
            if not pool:
                continue
            if len(pool) > cap:
                rng = np.random.default_rng((self.train_cfg.seed, 17, generation, qi))
                pool = rng.choice(pool, cap, replace=False)
            pools[qi, :len(pool)] = pool
        kk = min(k, pools.shape[1])
        out = np.full((n, kk), -1, np.int64)
        chunk = 4096
        with torch.inference_mode():
            for s in range(0, n, chunk):
                ids = np.arange(s, min(s + chunk, n))
                res = _hardest_chunk(lat, torch.as_tensor(pools[ids], device=lat.device),
                                     torch.as_tensor(ids, device=lat.device), kk)
                out[s:s + len(ids)] = res.cpu().numpy()
        return out

    def hard_negatives(self, query_idx: int) -> list[int] | None:
        """A row of the matrix ``refresh`` computed; called concurrently by
        the loader's workers (one read keeps matrix and generation paired)."""
        hard = self._hard
        if hard is None:
            return None
        out = [int(i) for i in hard[0][query_idx] if i >= 0]
        return out or None

    def attach(self, loader: TupleLoader) -> None:
        loader.set_hard_negatives(self.hard_negatives)
