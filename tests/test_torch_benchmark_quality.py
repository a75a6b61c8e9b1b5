"""The CI-scale quality band of ``tests/test_benchmark_quality.py``, run
through the port (``epcnet_torch.scripts.multiseed.ci_run``: ``Trainer(...,
checkpoints=False, device="cpu")`` and ``evaluate_region``): the same dataset
(3 runs x 40 submaps x 256 points, difficulty 0.5), the same tiny model, the
same ``TrainConfig``, the same seeds and the same bounds (``CI_BAND``: JAX's
calibration, 0.196 untrained / 0.500 trained, seeds 0.479 / 0.513 / 0.400).
Both are ``slow``, as JAX's are."""

import pytest

from epcnet_torch.scripts import multiseed
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def benchmark_root(tmp_path_factory):
    return multiseed.ci_dataset(str(tmp_path_factory.mktemp("epcnet_bench")))


@pytest.mark.slow
def test_trained_model_beats_untrained_with_headroom(benchmark_root, tmp_path):
    b = multiseed.CI_BAND
    res = multiseed.ci_run(benchmark_root, 1234, str(tmp_path), device="cpu", untrained=True)
    r_un, r_tr = res["untrained"], res["trained"]
    assert r_un <= b["untrained_max"], f"untrained recall@1 {r_un:.3f} suspiciously high"
    assert r_tr >= b["trained_min"], f"trained recall@1 {r_tr:.3f} regressed below band"
    assert r_tr < 1.0, "benchmark saturated — difficulty dial broken"
    assert r_tr - r_un >= b["separation"], (
        f"training no longer separates from chance: {r_tr:.3f} vs {r_un:.3f}")


@pytest.mark.slow
def test_seed_variance_stays_inside_regression_band(benchmark_root, tmp_path):
    b = multiseed.CI_BAND
    recalls = {seed: multiseed.ci_run(benchmark_root, seed, str(tmp_path / str(seed)),
                                      device="cpu")["trained"]
               for seed in multiseed.CI_SEEDS}
    vals = sorted(recalls.values())
    assert all(v >= b["seed_min"] for v in vals), (
        f"a seed fell out of the regression band: {recalls}")
    assert vals[-1] - vals[0] <= b["spread_max"], (
        f"seed-to-seed spread {vals[-1] - vals[0]:.3f} exceeds the band's slack: {recalls}")
