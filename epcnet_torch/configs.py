"""Frozen dataclass configs (SURVEY.md §5.6).

The PyTorch port's own copy of ``epcnet_tpu/configs.py``: same fields,
defaults, validation and JSON format, so a config written by either package
reads in the other. The port imports nothing of ``epcnet_tpu``, so the copy
is kept here; ``tests/test_torch_isolation.py`` holds the two in step.

The reference family configures everything through argparse flags plus
module-level constants in train.py / evaluate.py [LINEAGE: train.py argparse
block]. Here every structural hyperparameter lives in a frozen dataclass so
that (a) a later diff against the real reference is a config change, not a
rewrite (SURVEY.md §7.4), and (b) configs serialize to JSON alongside
checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network topology. Defaults follow EPC-Net [PAPER Fig. 2, §III].

    Every field the parity contract depends on (K, channel plan, cluster
    count, group count) is here — see SURVEY.md §7.4 "Parity without
    readable reference".
    """

    name: str = "epcnet"  # epcnet | epcnet_l | pointnetvlad | dgcnn_vlad | minkloc3dv2
    num_points: int = 4096
    knn_k: int = 20  # [MEMORY-LOW] spatial-adjacency kNN size
    # ProxyConv stack output channels [MEMORY-LOW ≈ 64,64,64,128]:
    proxyconv_channels: tuple[int, ...] = (64, 64, 64, 128)
    # Per-point lift applied to the concat of all ProxyConv outputs:
    lift_channels: tuple[int, ...] = (256, 1024)
    feature_dim: int = 1024  # per-point dim entering VLAD
    # G-VLAD head [PAPER §III-C]:
    vlad_clusters: int = 64  # [MEMORY-LOW]
    vlad_groups: int = 8  # [MEMORY-LOW] grouped-FC group count G
    vlad_group_dim: int = 32  # per-group FC output (G * group_dim pre-final)
    output_dim: int = 256  # global descriptor size
    gating: bool = True  # context-gating on the output (PointNetVLAD heritage)
    # PointNetVLAD-baseline specifics (BASELINE config #3):
    pointnet_channels: tuple[int, ...] = (64, 64, 64, 128, 1024)
    use_tnet: bool = True  # input/feature transform nets
    # Numerics:
    compute_dtype: str = "bfloat16"  # backbone matmul dtype (MXU)
    # distances + descriptor/L2-norm path stay fp32 (SURVEY.md §7.8)
    # VLAD accumulation precision: "highest" = fp32-exact (parity default);
    # "default" = single-pass MXU bf16 accumulation (~6x fewer MXU passes,
    # ~1e-3 relative descriptor drift) — an opt-in deployment knob.
    vlad_precision: str = "highest"
    # (A "knn_precision=bf16_fast" distance-slab mode was built and MEASURED
    # SLOWER — 14.9 vs 9.9 ms: the K=8 matmul wastes the MXU and the norm
    # expansion adds VPU passes; deleted per docs/KERNELS.md round 3.)
    use_pallas: bool = True  # swap in Pallas kernels (falls back off-TPU)
    # [N, N] adjacency layout for the ProxyConv neighbour means. "dense"
    # (and "auto" at production N): int8 indicator — fastest at production
    # shapes on v5e (the A@F matmuls are partly compute-bound;
    # docs/KERNELS.md). "packed": 1 bit/entry bit-planes, 8x less HBM — an
    # eval-path opt-in for memory-capacity-bound shapes; training always
    # uses dense (autodiff). "gather": NO adjacency at all — [N, K] id
    # gathers (idx-only blockwise kNN), the single-chip >32k capacity rung;
    # differentiable, so valid for training too. "auto" walks the ladder by
    # N: dense <= 16k < packed <= 32k < gather.
    adjacency_format: str = "auto"
    bn_momentum_final: float = 0.99  # BN "decay" upper clamp, reference-style

    def __post_init__(self):
        # fail fast on mode typos — "pakced" would otherwise silently take
        # the dense path (same contract as apply_overrides' unknown-key check)
        if self.adjacency_format not in ("auto", "dense", "packed", "gather"):
            raise ValueError(
                f"adjacency_format={self.adjacency_format!r} not in "
                "{'auto', 'dense', 'packed', 'gather'}"
            )
        if self.vlad_precision not in ("highest", "default"):
            raise ValueError(
                f"vlad_precision={self.vlad_precision!r} not in "
                "{'highest', 'default'}"
            )

    def variant(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def epcnet_l_config(**kw: Any) -> ModelConfig:
    """EPC-Net-L: the slimmer distillation student [PAPER §III-D]."""
    base = dict(
        name="epcnet_l",
        proxyconv_channels=(16, 16, 16, 32),
        lift_channels=(64, 256),
        feature_dim=256,
        vlad_clusters=64,
        vlad_groups=8,
        vlad_group_dim=32,
    )
    base.update(kw)
    return ModelConfig(**base)


def pointnetvlad_config(**kw: Any) -> ModelConfig:
    """PointNetVLAD baseline: plain PointNet + full (ungrouped) NetVLAD
    [LINEAGE: mikacuy/pointnetvlad models/pointnetvlad_cls.py]. Used for the
    aggregation-kernel parity check (BASELINE config #3)."""
    base = dict(name="pointnetvlad", vlad_groups=1, vlad_group_dim=256)
    base.update(kw)
    return ModelConfig(**base)


def dgcnn_vlad_config(**kw: Any) -> ModelConfig:
    """DGCNN-VLAD: the DGCNN backbone [LINEAGE: WangYueFt/dgcnn
    pytorch/model.py class DGCNN; arXiv:1801.07829] under PointNetVLAD's
    NetVLAD head [arXiv:1804.03492], at the published widths (k=20). A model
    of the port alone (``models/dgcnn.py``); the JAX package has none. It
    reuses the fields it needs: ``proxyconv_channels`` holds the EdgeConv
    widths, ``lift_channels`` conv5, and ``adjacency_format="gather"`` says
    that every layer's graph is id lists (built again at each layer)."""
    base = dict(
        name="dgcnn_vlad",
        proxyconv_channels=(64, 64, 128, 256),
        lift_channels=(1024,),
        feature_dim=1024,
        vlad_clusters=64,
        vlad_groups=1,
        vlad_group_dim=256,
        adjacency_format="gather",
    )
    base.update(kw)
    return ModelConfig(**base)


def minkloc3dv2_config(**kw: Any) -> ModelConfig:
    """MinkLoc3Dv2: MinkFPN with ECA blocks and GeM on sparse voxels
    [LINEAGE: jac99/MinkLoc3Dv2, its MinkLoc3Dv2 model config;
    arXiv:2203.00972], at the published widths. A model of the port alone
    (``models/minkloc.py``); the JAX package has none. It reuses the fields
    it needs: ``proxyconv_channels`` holds the planes of the four levels,
    ``lift_channels`` the top-down width (``feature_size``), and
    ``feature_dim`` = ``output_dim`` = that width (GeM keeps it). The rest
    of the published settings (layers, top-down count, conv0's kernel, the
    quantization step, ECA's rule, GeM's p) are constants of the model."""
    base = dict(
        name="minkloc3dv2",
        proxyconv_channels=(64, 128, 64, 32),
        lift_channels=(256,),
        feature_dim=256,
        output_dim=256,
    )
    base.update(kw)
    return ModelConfig(**base)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset layout + tuple-generation rules (SURVEY.md §2.1 P1–P4)."""

    dataset_root: str = "benchmark_datasets"
    runs_subdir: str = "oxford"
    num_points: int = 4096
    # Tuple-generation radii in metres (UTM) [LINEAGE: generating_queries/*]:
    positive_radius_m: float = 10.0
    negative_radius_m: float = 50.0
    test_positive_radius_m: float = 25.0
    # Tuple shape [LINEAGE: train.py constants]:
    num_positives: int = 2
    num_negatives: int = 18
    use_other_neg: bool = True  # quadruplet's fourth element
    # Augmentation [LINEAGE: loading_pointclouds.py]:
    rotate: bool = True
    jitter_sigma: float = 0.005
    jitter_clip: float = 0.05
    # Loader:
    prefetch_depth: int = 4
    loader_threads: int = 4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule / mining knobs [LINEAGE: train.py argparse]."""

    batch_num_queries: int = 2  # tuples per step (ref default 2)
    max_epoch: int = 20
    learning_rate: float = 5e-5
    lr_decay_steps: int = 200000
    lr_decay_rate: float = 0.7
    optimizer: str = "adam"
    momentum: float = 0.9  # if optimizer == "momentum"
    # Loss [LINEAGE: loss/pointnetvlad_loss.py]:
    loss: str = "lazy_quadruplet"  # triplet|lazy_triplet|quadruplet|lazy_quadruplet
    margin_1: float = 0.5
    margin_2: float = 0.2
    # BN decay schedule (reference keeps TF-style bn_decay):
    bn_init_decay: float = 0.5
    bn_decay_rate: float = 0.5
    bn_decay_steps: int = 200000
    bn_decay_clip: float = 0.99
    # Hard-negative mining [LINEAGE: train.py TRAINING_LATENT_VECTORS]:
    mining_start_epoch: int = 5
    mining_refresh_steps: int = 700  # refresh the latent cache every N steps
    hard_neg_per_tuple: int = 10  # hardest negs sampled from cache
    sampled_neg_pool: int = 4000
    # Steps fused into ONE device dispatch via lax.scan (train/step.py
    # build_multi_train_step): amortizes per-dispatch host overhead; results
    # are bit-identical to steps_per_dispatch=1. Mining/log/checkpoint
    # cadences fire on boundary CROSSINGS, so they are honored at dispatch
    # granularity.
    steps_per_dispatch: int = 1
    # Memory-capacity levers (TPU-idiomatic; the reference has neither):
    # remat: wrap the model forward in jax.checkpoint so the backward pass
    # recomputes activations instead of keeping them in HBM — EXACT same
    # numbers (tested), ~the activation footprint of one forward in exchange
    # for one extra forward of FLOPs. Buys larger batch_num_queries per chip.
    remat: bool = False
    # grad_accum_steps: split the tuple batch into A sequential micro-batches
    # inside ONE jitted step (lax.scan), averaging gradients before a single
    # optimizer update — peak activation memory drops ~A-fold. Mean-loss
    # gradients match the full batch exactly EXCEPT through BatchNorm, which
    # normalizes per micro-batch (standard accumulation semantics; BN EMA
    # stats chain A updates per optimizer step). batch_num_queries must be
    # divisible by this.
    grad_accum_steps: int = 1
    # Checkpoint / metrics:
    checkpoint_every_steps: int = 1000
    keep_checkpoints: int = 3
    log_every_steps: int = 20
    # Mirror numeric metrics as TensorBoard scalars under <log_dir>/tb —
    # the reference's tf.summary analogue (SURVEY.md §5.5). JSONL always on.
    tensorboard: bool = False
    seed: int = 1234

    def __post_init__(self):
        if self.grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps={self.grad_accum_steps} must be >= 1"
            )
        if self.batch_num_queries % self.grad_accum_steps:
            raise ValueError(
                f"batch_num_queries={self.batch_num_queries} is not divisible "
                f"by grad_accum_steps={self.grad_accum_steps}"
            )


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (SURVEY.md §2.3). Axes:
    - "data": DP over quadruplet tuples (grads psum over ICI)
    - "db":   retrieval-database row sharding (ICI all-gather top-k merge)
    """

    data_axis: int = -1  # -1 => all available devices
    db_axis: int = 1
    axis_names: tuple[str, str] = ("data", "db")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Retrieval evaluation (SURVEY.md §3.2)."""

    top_k: int = 25
    batch_size: int = 64
    regions: tuple[str, ...] = ("oxford", "university", "residential", "business")
    latency_probe_queries: int = 256


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    log_dir: str = "log"

    # ---- JSON round-trip ----------------------------------------------
    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        raw = json.loads(text)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "ExperimentConfig":
        def build(dc_cls, d):
            if d is None:
                return dc_cls()
            kw = {}
            for f in dataclasses.fields(dc_cls):
                if f.name in d:
                    v = d[f.name]
                    if isinstance(v, list):
                        v = tuple(v)
                    kw[f.name] = v
            return dc_cls(**kw)

        return cls(
            model=build(ModelConfig, raw.get("model")),
            data=build(DataConfig, raw.get("data")),
            train=build(TrainConfig, raw.get("train")),
            mesh=build(MeshConfig, raw.get("mesh")),
            eval=build(EvalConfig, raw.get("eval")),
            log_dir=raw.get("log_dir", "log"),
        )


def apply_overrides(cfg: ExperimentConfig, overrides: Sequence[str]) -> ExperimentConfig:
    """Apply ``section.field=value`` CLI overrides (the argparse analogue)."""
    d = dataclasses.asdict(cfg)
    for ov in overrides:
        key, _, val = ov.partition("=")
        parts = key.strip().split(".")
        cur = d
        for p in parts[:-1]:
            # friendly errors for typo'd sections / over-deep keys too (a
            # bare KeyError('trian') or "string indices" TypeError hides
            # what went wrong)
            if not isinstance(cur, dict) or p not in cur:
                raise KeyError(f"unknown config key: {key}")
            cur = cur[p]
        leaf = parts[-1]
        if not isinstance(cur, dict) or leaf not in cur:
            raise KeyError(f"unknown config key: {key}")
        old = cur[leaf]
        cur[leaf] = _coerce(val.strip(), old)
    return ExperimentConfig.from_dict(d)


def _coerce(val: str, old: Any) -> Any:
    if isinstance(old, bool):
        return val.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int) and not isinstance(old, bool):
        return int(val)
    if isinstance(old, float):
        return float(val)
    if isinstance(old, (tuple, list)):
        items = [x for x in val.strip("()[]").split(",") if x.strip()]
        elem = old[0] if len(old) else ""
        return tuple(_coerce(x.strip(), elem) for x in items)
    return val
