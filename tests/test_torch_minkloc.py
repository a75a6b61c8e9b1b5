"""MinkLoc3Dv2 (``epcnet_torch/models/minkloc.py``), its voxels and kernel maps
(``ops/sparse.py``) and K11's plain version against plain references on the
CPU.

The reference is ``tests/plain_minkloc3dv2.py`` (torch only, fp32, its own
voxels and maps from a dense lookup grid), on the port's seeded weights
(``init_flat_variables``) at the published widths (planes 64, 128, 64, 32;
feature size 256; conv0 5³), B=2 blob submaps of N=1024 points, in eval.
Tolerances (relative L2 of the descriptors, which are not unit-norm), from
the worst of seeds 0-7:

- fp32 (the algorithm): 7.4e-8 -> 1e-6 (sums in another order: the port
  adds an offset's products into an fp32 sum, the reference adds whole
  products, and BN's rsqrt against the reference's division).
- bf16 (the configuration's precision: K11's plain twin, K9's, bf16
  between layers): 1.4e-3 to 3.6e-3 -> 6e-3; it must fail the fp32
  tolerance, and does by three orders of magnitude.
- the voxels at every stride and every kernel map's pairs are integers
  computed two ways: equal exactly, compared as sorted sets.

Training (``train=True``) runs the plain twin with autograd and BN over all
voxels of the batch: every gradient against the reference's autograd on the
same forward, both in fp64 (``compute_dtype="float64"``, ``model.double()``),
N=512: worst over seeds 0-7 2.2e-15 of the tensor's largest -> 1e-12; the
batch statistics 1e-13.
"""

import numpy as np
import pytest
import torch

import plain_minkloc3dv2 as plain
from epcnet_torch.configs import ExperimentConfig, minkloc3dv2_config
from epcnet_torch.models import MinkLoc3Dv2, get_model, minkloc, param_count
from epcnet_torch.ops import sparse
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.utils.profiling import region_ms
from epcnet_torch.weights import flat_variables, init_flat_variables, load_flat_variables

N, B = 1024, 2
PARAMS = 2_663_567
FP32_TOL = 1e-6
BF16_TOL = 6e-3
GRAD_TOL, STATS_TOL = 1e-12, 1e-13


@pytest.fixture(scope="module", autouse=True)
def four_torch_threads():
    """A fixed thread count, so each result is the same on every run."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def _clouds(seed, b=B, n=N):
    """Blob submaps (a few gaussian blobs in [-1, 1]: dense and sparse
    regions side by side), as the benchmark's."""
    rng = np.random.default_rng(70 + seed)
    out = np.empty((b, n, 3), np.float32)
    for i in range(b):
        nb = int(rng.integers(3, 13))
        centers = rng.uniform(-0.8, 0.8, (nb, 3))
        scales = rng.uniform(0.02, 0.2, (nb, 1))
        pick = rng.choice(nb, n, p=rng.dirichlet(np.ones(nb)))
        out[i] = np.clip(centers[pick] + scales[pick] * rng.standard_normal((n, 3)), -1, 1)
    return torch.tensor(out)


def _model(seed, dtype="bfloat16"):
    cfg = minkloc3dv2_config(compute_dtype=dtype)
    model = get_model(cfg, "cpu")
    load_flat_variables(model, init_flat_variables(cfg, seed))
    if dtype == "float64":
        model.double()
    wdt = torch.float64 if dtype == "float64" else torch.float32
    weights = {k: v.detach().to(wdt).clone() for k, v in model.state_dict().items()}
    return model, weights


def _rel_gap(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())


def test_published_widths():
    cfg = minkloc3dv2_config()
    assert (cfg.proxyconv_channels, cfg.lift_channels, cfg.feature_dim, cfg.output_dim,
            cfg.compute_dtype) == ((64, 128, 64, 32), (256,), 256, 256, "bfloat16")
    model = get_model(cfg, "cpu")
    assert isinstance(model, MinkLoc3Dv2) and param_count(model) == PARAMS
    assert (minkloc.LAYERS, minkloc.NUM_TOP_DOWN, minkloc.CONV0_KERNEL_SIZE,
            minkloc.QUANTIZATION_STEP, minkloc.GEM_P, minkloc.GEM_EPS,
            minkloc.BN_EPSILON) == ((1, 1, 1, 1), 2, 5, 0.01, 3.0, 1e-6, 1e-5)
    # ECA's kernel: 3 at 32 and 64 channels, 5 at 128
    assert [minkloc.eca_kernel_size(c) for c in (32, 64, 128)] == [3, 3, 5]
    assert [tuple(getattr(model, f"block_{i}").eca.weight.shape) for i in range(4)] == \
        [(3,), (5,), (3,), (3,)]
    assert model.conv0.offset_weight.shape == (125, 1, 64)
    assert model.tconv_0.offset_weight.shape == (8, 256, 256)
    assert [hasattr(getattr(model, f"block_{i}"), "downsample") for i in range(4)] == \
        [False, True, True, True]
    with pytest.raises(ValueError, match="planes"):
        get_model(cfg.variant(proxyconv_channels=(64, 64)), "cpu")


def test_voxels_floor_below_zero():
    """floor(p / 0.01), not truncation: -0.005 lies in voxel -1, and a
    point exactly on a boundary in the voxel above it."""
    pts = torch.tensor([[[-0.005, 0.005, 0.0], [-0.015, 0.0, 0.01], [0.0, 0.0, 0.0]]])
    coords = sparse.SparseCoordinates(pts, 0.01, 2)
    assert (int(coords.rows[1]), int(coords.rows[2])) == (3, 2)
    _, c = sparse.decode(coords.keys[1][:3])
    assert c.tolist() == [[-2, 0, 1], [-1, 0, 0], [0, 0, 0]]
    _, c2 = sparse.decode(coords.keys[2][:2])
    assert c2.tolist() == [[-2, 0, 0], [0, 0, 0]]  # floor(c / 2) * 2
    assert coords.keys[2][2:].tolist() == [sparse.SENTINEL]  # the padding
    assert coords.cloud[2].tolist() == [0, 0, 1] and coords.counts[2].tolist() == [2, 1]
    with pytest.raises(ValueError, match="beyond"):
        sparse.check_range(torch.full((1, 2, 3), 400.0), 0.01)


def _pairs(nbr, out_rows, in_rows):
    """A map as the sorted set of (output voxel, offset, input voxel)."""
    o_idx, k = (nbr >= 0).nonzero(as_tuple=True)
    src = nbr[o_idx, k].long()
    rows = torch.cat([out_rows[o_idx], k[:, None], in_rows[src]], 1)
    return sorted(map(tuple, rows.tolist()))


def _rows(keys):
    cloud, c = sparse.decode(keys)
    return torch.cat([cloud[:, None], c], 1)


@pytest.mark.parametrize("seed", [0, 3])
def test_voxels_and_maps_equal_the_reference(seed):
    """Every stride's voxels and every kernel map, as sorted sets, equal
    the reference's (its own grid lookup, not the port's sorted keys)."""
    x = _clouds(seed)
    model = get_model(minkloc3dv2_config(), "cpu")
    coords = sparse.SparseCoordinates(x, minkloc.QUANTIZATION_STEP, 16)
    maps = model.build_maps(coords)
    vox = plain.Voxels(x)
    rows = {s: _rows(k[:int(coords.rows[s])]) for s, k in coords.keys.items()}
    for s, v in vox.v.items():
        assert sorted(map(tuple, rows[s].tolist())) == sorted(map(tuple, v.tolist())), s
    want = {"conv0": _pairs(plain.odd_table(vox.v[1], 1, 5), vox.v[1], vox.v[1])}
    for i in range(4):
        s = 2 ** i
        down = torch.full((vox.v[2 * s].shape[0], 8), -1, dtype=torch.long)
        down[vox.parent[s], vox.slot[s]] = torch.arange(vox.v[s].shape[0])
        want[f"down_{i}"] = _pairs(down, vox.v[2 * s], vox.v[s])
        want[f"block_{i}"] = _pairs(plain.odd_table(vox.v[2 * s], 2 * s, 3), vox.v[2 * s],
                                    vox.v[2 * s])
    for j, s in enumerate((8, 4)):
        up = torch.full((vox.v[s].shape[0], 8), -1, dtype=torch.long)
        up[torch.arange(vox.v[s].shape[0]), vox.slot[s]] = vox.parent[s]
        want[f"up_{j}"] = _pairs(up, vox.v[s], vox.v[2 * s])
    ins = {"conv0": 1, **{f"down_{i}": 2 ** i for i in range(4)},
           **{f"block_{i}": 2 ** (i + 1) for i in range(4)}, "up_0": 16, "up_1": 8}
    outs = {**ins, **{f"down_{i}": 2 ** (i + 1) for i in range(4)}, "up_0": 8, "up_1": 4}
    assert set(maps) == set(want) == set(minkloc.map_names())
    for name, m in maps.items():
        assert m.nbr.dtype == torch.int32
        assert _pairs(m.nbr, rows[outs[name]], rows[ins[name]]) == want[name], name


@pytest.mark.parametrize("seed", [0, 5])
def test_fp32_matches_plain(seed):
    model, w = _model(seed, "float32")
    x = _clouds(seed)
    with torch.no_grad():
        got, want = model(x), plain.forward(w, x)
    assert got.dtype == torch.float32 and got.shape == (B, 256)
    assert _rel_gap(got, want) <= FP32_TOL


@pytest.mark.parametrize("seed", [0, 5])
def test_bf16_matches_plain_and_fails_the_fp32_tolerance(seed):
    model, w = _model(seed)
    x = _clouds(seed)
    with torch.no_grad():
        gap = _rel_gap(model(x), plain.forward(w, x))
    assert FP32_TOL < 100 * FP32_TOL < gap <= BF16_TOL


def test_counters_equal_the_reference():
    """Forwards, voxels at each stride and each map's pairs, cumulative
    over two forwards."""
    model, _ = _model(1)
    xs = [_clouds(1), _clouds(2, b=3, n=600)]
    with torch.no_grad():
        for x in xs:
            model(x)
    got = model.counters()
    want = [plain.counts(x) for x in xs]
    assert got["forwards"] == 2
    assert got["voxels"] == {s: want[0]["voxels"][s] + want[1]["voxels"][s]
                             for s in want[0]["voxels"]}
    assert got["pairs"] == {m: want[0]["pairs"][m] + want[1]["pairs"][m]
                            for m in want[0]["pairs"]}


@pytest.mark.parametrize("cin,cout,k", [(1, 64, 125), (64, 128, 27), (256, 256, 8)])
def test_sparse_conv_plain_matches_fp64_gather_sum(cin, cout, k):
    """K11's plain twin on bf16 against the exact sum in fp64 of the same
    bf16 operands: within half a bf16 ulp of the result (its one rounding)
    plus fp32's rounding of the sum (K·2^-24 of the terms' magnitudes); on
    fp64 operands within 1e-12."""
    g = torch.Generator().manual_seed(cin + k)
    x = torch.randn(300, cin, generator=g)
    nbr = torch.randint(-1, 300, (200, k), generator=g, dtype=torch.int32)
    nbr[::7] = -1  # rows with no pairs
    w = torch.randn(k, cin, cout, generator=g) / (k * cin) ** 0.5
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    xp = torch.cat([xb.double(), torch.zeros(1, cin, dtype=torch.float64)])
    terms = xp[nbr.long()][..., None] * wb.double()[None]  # [rows, k, cin, cout]
    exact = terms.sum((1, 2))
    got = sparse.sparse_conv_plain(xb, sparse.KernelMap(nbr, 300), wb)
    assert got.dtype == torch.bfloat16 and got.shape == (200, cout)
    assert float(got[::7].abs().max()) == 0.0
    err = (got.double() - exact).abs()
    assert bool((err <= 2.0 ** -8 * exact.abs() + k * cin * 2.0 ** -24
                 * terms.abs().amax((1, 2))).all())
    got64 = sparse.sparse_conv_plain(x.double(), sparse.KernelMap(nbr, 300), w.double())
    xp = torch.cat([x.double(), torch.zeros(1, cin, dtype=torch.float64)])
    want64 = torch.einsum("rkc,kcd->rd", xp[nbr.long()], w.double())
    assert float((got64 - want64).abs().max()) <= 1e-12


def test_sparse_conv_cuda_refuses_the_cpu():
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    km = sparse.KernelMap(torch.zeros(4, 27, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="CUDA"):
        sparse.sparse_conv_cuda(x, km, torch.zeros(27, 64, 64))


@pytest.mark.parametrize("case", ["eval", "train", "grad", "float32"])
def test_kernel_path_only_where_no_graph_is_built(case, monkeypatch):
    """A bf16 model in eval without grad takes ``sparse_conv`` (K11 on the
    card) for all 15 convolutions over a map; training, grad-enabled calls
    and fp32 take the differentiable plain twin."""
    calls = {"sparse_conv": 0, "sparse_conv_plain": 0}

    def spy(name):
        fn = getattr(minkloc, name)

        def counted(*args):
            calls[name] += 1
            return fn(*args)
        monkeypatch.setattr(minkloc, name, counted)

    spy("sparse_conv")
    spy("sparse_conv_plain")
    model, _ = _model(2, "float32" if case == "float32" else "bfloat16")
    with torch.set_grad_enabled(case in ("train", "grad")):
        model(_clouds(2, n=300), train=case == "train")
    assert calls == ({"sparse_conv": 15, "sparse_conv_plain": 0} if case == "eval" else
                     {"sparse_conv": 0, "sparse_conv_plain": 15})


@pytest.mark.parametrize("seed", [0, 1])
def test_train_gradients_match_plain_autograd(seed):
    model, w = _model(seed, "float64")
    x = _clouds(seed, n=512)
    r = torch.randn(B, 256, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    (model(x, train=True) * r).sum().backward()
    params = dict(model.named_parameters())
    wg = {k: v.clone().requires_grad_(k in params) for k, v in w.items()}
    stats = {}
    (plain.forward(wg, x, train=True, stats=stats) * r).sum().backward()
    for key, p in params.items():
        want = wg[key].grad
        assert p.grad.dtype == torch.float64, key
        scale = float(want.abs().max())
        assert scale > 0 and float((p.grad - want).abs().max()) <= GRAD_TOL * scale, key
    mods = dict(model.named_modules())
    assert len(stats) == 16
    for key, (mean, var) in stats.items():
        got_mean, got_var, _ = mods[key].pending
        assert float((got_mean - mean).abs().max()) <= STATS_TOL, key
        assert float((got_var - var).abs().max()) <= STATS_TOL, key


def test_embed_fn_and_flat_names_round_trip():
    """The normal path: a config read back from JSON, ``build_embed_fn``
    with the flat names, which come back unchanged."""
    cfg = ExperimentConfig(model=minkloc3dv2_config(num_points=300))
    back = ExperimentConfig.from_json(cfg.to_json()).model
    assert back == cfg.model
    flat = init_flat_variables(back, seed=4)
    assert flat["params/conv0/offset_weight"].shape == (125, 1, 64)
    assert flat["params/conv1x1_0/kernel"].shape == (32, 256)
    assert flat["params/gem/p"].tolist() == [3.0]
    assert flat["batch_stats/block_1/downsample_bn/var"].shape == (128,)
    embed = build_embed_fn(back, device="cpu", variables=flat)
    out = embed(np.asarray(_clouds(4, n=300)))
    assert out.shape == (B, 256) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all()) and float(out.min()) > 0  # GeM of clamped values
    assert {k: v.tolist() for k, v in flat_variables(embed.model).items()} == \
        {k: v.tolist() for k, v in flat.items()}


def test_spans_name_each_stage():
    """The spans the benchmark's per-layer readers read, once a forward;
    every map lookup (``searchsorted``) runs inside ``minkloc/kmap``, and
    the clouds' voxel counts (a search too) inside ``minkloc/voxelize``."""
    model, _ = _model(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(_clouds(0, n=300))
    regions = region_ms(prof, "minkloc/")
    want = {"minkloc/voxelize", "minkloc/kmap", "minkloc/conv0", "minkloc/gem",
            *(f"minkloc/{part}_{i}" for part in ("down", "block") for i in range(4)),
            "minkloc/up_0", "minkloc/up_1"}
    assert set(regions) == want and all(r["count"] == 1 for r in regions.values())
    events = list(prof.events())
    spans = {e.name: e.time_range for e in events
             if e.name in ("minkloc/kmap", "minkloc/voxelize")}
    lookups = [e.time_range for e in events if e.name == "aten::searchsorted"]

    def inside(name):
        return sum(spans[name].start <= t.start and t.end <= spans[name].end for t in lookups)

    # conv0's 5³ and the four 3³ maps; the counts at the five strides
    assert (inside("minkloc/kmap"), inside("minkloc/voxelize"), len(lookups)) == (5, 5, 10)
