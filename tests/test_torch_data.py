"""The port's data plane against the JAX package's, on the CPU: point-cloud
IO and augmentation, the native loader (with its library and without),
the synthetic dataset (byte-equal files), the tables, dicts and pickles of
the tuple tools, and the ``generate_tuples`` CLI in each mode. Everything
here is exact: equal arrays, files, dicts and pickles."""

import filecmp
import os

import numpy as np
import pytest

from epcnet_tpu.cli import generate_tuples as j_gen
from epcnet_tpu.data import native_loader as j_native
from epcnet_tpu.data import pointclouds as j_pc
from epcnet_tpu.data import synthetic as j_syn
from epcnet_tpu.data import tuples as j_tup

from epcnet_torch.cli import generate_tuples as t_gen
from epcnet_torch.data import native_loader as t_native
from epcnet_torch.data import pointclouds as t_pc
from epcnet_torch.data import synthetic as t_syn
from epcnet_torch.data import tuples as t_tup

SYNTH = dict(num_runs=2, submaps_per_run=6, num_points=64)
VARIANTS = {"easy": {}, "difficulty": dict(difficulty=0.5),
            "resample": dict(resample_per_visit=True)}


def _bins(tmp_path, sizes, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(sizes):
        p = tmp_path / f"c{i}.bin"
        rng.uniform(-1, 1, (n, 3)).astype(np.float64).tofile(p)
        paths.append(str(p))
    return paths


def test_load_pc_file_matches(tmp_path):
    paths = _bins(tmp_path, [64, 64, 100])
    for p in paths[:2]:
        np.testing.assert_array_equal(t_pc.load_pc_file(p, num_points=64),
                                      j_pc.load_pc_file(p, num_points=64))
    root, name = os.path.split(paths[2])
    got = t_pc.load_pc_file(name, root, num_points=None)
    assert got.dtype == np.float32 and got.shape == (100, 3)
    np.testing.assert_array_equal(got, j_pc.load_pc_file(name, root, num_points=None))
    np.testing.assert_array_equal(t_pc.load_pc_files(paths[:2], num_points=64),
                                  j_pc.load_pc_files(paths[:2], num_points=64))
    np.zeros(10).tofile(tmp_path / "bad.bin")
    np.zeros(0).tofile(tmp_path / "empty.bin")
    for path, n in ((tmp_path / "bad.bin", 64), (tmp_path / "bad.bin", None),
                    (tmp_path / "empty.bin", None), (paths[2], 64)):
        with pytest.raises(ValueError) as want:
            j_pc.load_pc_file(str(path), num_points=n)
        with pytest.raises(ValueError) as got:
            t_pc.load_pc_file(str(path), num_points=n)
        assert str(got.value) == str(want.value)


def test_augmentation_matches():
    x = np.random.RandomState(3).randn(3, 50, 3).astype(np.float32)
    np.testing.assert_array_equal(
        t_pc.rotate_point_cloud(x, np.random.default_rng(5)),
        j_pc.rotate_point_cloud(x, np.random.default_rng(5)))
    for sigma, clip in ((0.005, 0.05), (0.5, 0.03)):
        np.testing.assert_array_equal(
            t_pc.jitter_point_cloud(x, sigma, clip, np.random.default_rng(6)),
            j_pc.jitter_point_cloud(x, sigma, clip, np.random.default_rng(6)))


@pytest.mark.parametrize("with_library", [True, False])
def test_native_loader_matches(tmp_path, monkeypatch, with_library):
    """The same library through both bindings, and the port's fallback
    (``load_pc_file``) with the library taken away."""
    paths = _bins(tmp_path, [256] * 5, seed=1)
    want = j_native.load_pc_files_native(paths, num_points=256)
    if not with_library:
        monkeypatch.setattr(t_native, "_get_lib", lambda: None)
    else:
        assert t_native.native_available()
    got = t_native.load_pc_files_native(paths, num_points=256, n_threads=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, t_pc.load_pc_files(paths, num_points=256))
    out = np.full((5, 256, 3), 7.0, np.float32)
    assert t_native.load_pc_files_native(paths, num_points=256, out=out) is out
    np.testing.assert_array_equal(out, want)
    root = os.path.dirname(paths[0])
    names = [os.path.basename(p) for p in paths]
    np.testing.assert_array_equal(t_native.load_pc_files_native(names, root, 256), want)
    with pytest.raises(ValueError, match="need float32"):
        t_native.load_pc_files_native(paths, num_points=256, out=np.zeros((4, 256, 3),
                                                                             np.float32))
    short = tmp_path / "short"
    short.mkdir()
    # the library raises IOError, the fallback load_pc_file's ValueError
    with pytest.raises(IOError if with_library else ValueError):
        t_native.load_pc_files_native(paths[:1] + _bins(short, [100], 2), num_points=256)


def _walk_diff(cmp):
    _, mismatch, errors = filecmp.cmpfiles(cmp.left, cmp.right, cmp.common_files,
                                           shallow=False)
    bad = mismatch + errors + cmp.left_only + cmp.right_only
    for sub in cmp.subdirs.values():
        bad += _walk_diff(sub)
    return bad


@pytest.fixture(scope="module", params=list(VARIANTS))
def synth(request, tmp_path_factory):
    """The same dataset written by each package into its own directory."""
    kw = {**SYNTH, **VARIANTS[request.param]}
    base = tmp_path_factory.mktemp(f"synth_{request.param}")
    j_root = j_syn.generate_synthetic_dataset(str(base / "jax"), **kw)
    t_root = t_syn.generate_synthetic_dataset(str(base / "torch"), **kw)
    return j_root, t_root


def test_synthetic_files_byte_equal(synth):
    j_root, t_root = synth
    bins = [f for _, _, fs in os.walk(t_root) for f in fs if f.endswith(".bin")]
    assert len(bins) == SYNTH["num_runs"] * SYNTH["submaps_per_run"]
    assert _walk_diff(filecmp.dircmp(j_root, t_root)) == []


def test_synthetic_csv_rows_read_back(synth):
    """Every row gives the same timestamp string and float64 values, read
    by pandas (the JAX package's reader) and by the port's reader."""
    import pandas as pd

    j_root, t_root = synth
    for r in range(SYNTH["num_runs"]):
        rel = os.path.join("oxford", f"run_{r:02d}", "pointcloud_locations_20m_10overlap.csv")
        want = pd.read_csv(os.path.join(j_root, rel), dtype={"timestamp": str})
        stamps, north, east = t_tup._read_run_csv(os.path.join(t_root, rel))
        assert stamps == list(want["timestamp"])
        np.testing.assert_array_equal(north, want["northing"].to_numpy())
        np.testing.assert_array_equal(east, want["easting"].to_numpy())
        assert north.dtype == np.float64 and stamps[0] == f"{r:02d}000000"


def _assert_tables_equal(table, df):
    assert set(table) == set(t_tup.COLUMNS)
    assert table["file"] == list(df["file"]) and table["run"] == list(df["run"])
    for col in ("northing", "easting"):
        np.testing.assert_array_equal(table[col], df[col].to_numpy())


def test_scan_runs_across_packages(synth):
    """The JAX reader on the port's dataset and the port's on JAX's give
    equal tables."""
    j_root, t_root = synth
    _assert_tables_equal(t_tup.scan_runs(j_root), j_tup.scan_runs(t_root))
    _assert_tables_equal(t_tup.scan_runs(t_root, "oxford", "pointcloud_20m_10overlap",
                                         "pointcloud_locations_20m_10overlap.csv"),
                         j_tup.scan_runs(j_root))
    with pytest.raises(FileNotFoundError):
        t_tup.scan_runs(t_root, runs_subdir="oxford/run_00/pointcloud_20m_10overlap")


def test_parse_float_follows_pandas():
    """The csv number rule is pandas' default C parser, which rounds about
    1 value in 40 of a UTM column one ulp away from ``float``."""
    import io

    import pandas as pd

    rng = np.random.default_rng(9)
    vals = np.concatenate([rng.uniform(5e6, 6e6, 4000), rng.uniform(5e5, 7e5, 4000),
                           rng.normal(0, 1e-4, 1000), 10 ** rng.uniform(-300, 300, 1000)])
    texts = [repr(float(v)) for v in vals] + [
        "0.000123456789012345678901", "123456789012345678901234.5", "1E-5", "+3.25",
        "-0", "00012.5000", ".5", "1.5e+300", "1e400", "4.9e-324", "2.5e-310"]
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(texts)))["x"].to_numpy()
    got = np.array([t_tup._parse_float(s) for s in texts])
    np.testing.assert_array_equal(got, want)
    assert (want != np.array([float(s) for s in texts])).sum() > 50  # the rules differ
    with pytest.raises(ValueError):
        t_tup._parse_float("12x")


def test_tuple_dicts_match(synth):
    _, t_root = synth
    df, table = j_tup.scan_runs(t_root), t_tup.scan_runs(t_root)
    for pos, neg in ((10.0, 50.0), (30.0, 60.0)):
        for excl in (True, False):
            want = j_tup.construct_query_dict(df, pos, neg, exclude_test_regions=excl).queries
            got = t_tup.construct_query_dict(table, pos, neg, exclude_test_regions=excl).queries
            assert got == want
    for only in (False, True):
        got = t_tup.construct_query_and_database_sets(table, 25.0, only_test_regions=only)
        assert got == j_tup.construct_query_and_database_sets(df, 25.0,
                                                              only_test_regions=only)
    assert t_tup.any_in_test_regions(table) is j_tup.any_in_test_regions(df) is False


def _hand_table():
    """Four submaps of two runs inside the first Oxford rectangle, and two
    far from it; 10 m (6, 8) and 25 m (15, 20) apart exactly, so a point
    lies at exactly each radius."""
    n0, e0 = 5735700.0, 620080.0
    pts = [(n0, e0, "a"), (n0 + 6, e0 + 8, "a"), (n0 + 15, e0 + 20, "b"),
           (n0 + 200, e0, "b"), (5800000.0, 600000.0, "a"), (5800030.0, 600040.0, "b")]
    return {"file": [f"oxford/run_{r}/pc/{i:04d}.bin" for i, (_, _, r) in enumerate(pts)],
            "northing": np.array([p[0] for p in pts]),
            "easting": np.array([p[1] for p in pts]),
            "run": [p[2] for p in pts]}


def test_tuples_hand_case():
    import pandas as pd

    table = _hand_table()
    df = pd.DataFrame(table)
    assert t_tup.any_in_test_regions(table) is j_tup.any_in_test_regions(df) is True
    regions = [(5800000.0, 600000.0)]
    assert (t_tup.any_in_test_regions(table, regions, width=1.0)
            is j_tup.any_in_test_regions(df, regions, width=1.0) is True)
    for n, e in zip(table["northing"], table["easting"]):
        for width in (150.0, 10.0):
            assert (t_tup.in_test_region(n, e, width=width)
                    == j_tup.in_test_region(n, e, width=width))
    for excl in (False, True):
        want = j_tup.construct_query_dict(df, 10.0, 25.0, exclude_test_regions=excl)
        got = t_tup.construct_query_dict(table, 10.0, 25.0, exclude_test_regions=excl)
        assert got.queries == want.queries and len(got) == len(want)
    got = t_tup.construct_query_dict(table, 10.0, 25.0, exclude_test_regions=False).queries
    assert got[0]["positives"] == [1]  # at exactly the radius: a positive
    assert got[0]["negatives"] == [3, 4, 5]  # 2 is at exactly 25 m: not a negative
    for only in (False, True):
        want = j_tup.construct_query_and_database_sets(df, 25.0, only_test_regions=only)
        got = t_tup.construct_query_and_database_sets(table, 25.0, only_test_regions=only)
        assert got == want
    db, q = t_tup.construct_query_and_database_sets(table, 25.0, only_test_regions=True)
    assert [len(d) for d in db] == [3, 3] and [len(s) for s in q] == [2, 1]
    assert q[0][0][1] == [0]  # run b's row 0 is exactly 25 m from run a's row 0


def _pickles(root, names):
    return {n: t_tup.load_pickle(os.path.join(root, n)) for n in names}


@pytest.mark.parametrize("mode", ["baseline", "refine", "test", "test_only_regions"])
def test_generate_tuples_cli_matches(tmp_path, mode):
    """The two CLIs on one dataset (a second region for refine) write equal
    pickles under the same names."""
    root = str(tmp_path / "data")
    gen = ["--dataset_root", root, "--synthetic", "--synthetic_runs", "2",
           "--synthetic_submaps", "6", "--num_points", "64", "--synthetic_difficulty", "0.5"]
    t_gen.main(gen + ["--output_dir", str(tmp_path / "setup")])
    if mode == "refine":
        t_syn.generate_synthetic_dataset(root, num_runs=2, submaps_per_run=5, num_points=64,
                                         runs_subdir="university", origin=(5810000.0, 610000.0))
    args = ["--dataset_root", root]
    if mode == "refine":
        args += ["--mode", "refine", "--runs_subdirs", "oxford", "university"]
    elif mode.startswith("test"):
        args += ["--mode", "test"]
        if mode == "test_only_regions":
            args += ["--only_test_regions", "true"]
    outs = {}
    for name, gen_main in (("jax", j_gen.main), ("torch", t_gen.main)):
        outs[name] = str(tmp_path / name)
        gen_main(args + ["--output_dir", outs[name]])
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["torch"])) and names
    assert _pickles(outs["torch"], names) == _pickles(outs["jax"], names)
    if mode == "test_only_regions":  # synthetic coordinates are off-Oxford
        q = t_tup.load_pickle(os.path.join(outs["torch"], "oxford_evaluation_query.pickle"))
        assert [len(s) for s in q] == [0, 0]
