"""Training-tuple and evaluation-set generation (twin of
``epcnet_tpu/data/tuples.py``, without pandas or scikit-learn).

Each run of a dataset has a locations csv (``timestamp,northing,easting``)
and a directory of ``<timestamp>.bin`` submaps. ``scan_runs`` reads all runs
into a plain table, a dict of four equal-length columns: ``file`` and
``run`` (lists of str), ``northing`` and ``easting`` (float64 arrays). From
it, with a UTM KD-tree (``scipy.spatial.cKDTree``):

  training pickle:  {idx: {"query": file, "northing", "easting",
                           "positives": [...], "negatives": [...]}}
  test sets:        per-run database and query dicts; each query entry
                    gains {db_run_idx: [ground-truth database indices]} for
                    every other run, positives = UTM distance <= 25 m.

Positives: distance <= 10 m; negatives: everything beyond 50 m. Fixed UTM
rectangles hold the Oxford test regions out of training. Every list is
sorted, and the dicts equal the JAX package's.

The csv's numbers are parsed as pandas' default C parser parses them
(``_parse_float``), not correctly rounded: about 1 value in 40 of a UTM
column differs by one ulp between the two rules, and the JAX package reads
through pandas. Parsing its way keeps the coordinates, and so every radius
test on them, the JAX package's to the bit.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import pickle
from typing import Sequence

import numpy as np
from scipy.spatial import cKDTree

# The Oxford RobotCar held-out test rectangles (UTM northing/easting centres).
OXFORD_TEST_REGIONS = [
    (5735712.768124, 620084.402381),
    (5735611.299219, 620540.270327),
    (5735237.358209, 620543.094379),
    (5734749.303802, 619932.693364),
]
OXFORD_REGION_WIDTH = 150.0  # metres, a HALF-width: each box spans ±150 m

COLUMNS = ("file", "northing", "easting", "run")


@dataclasses.dataclass
class TrainingTuples:
    """In-memory form of the training pickle."""

    queries: dict  # {idx: {"query": file, "positives": [...], "negatives": [...]}}

    def __len__(self):
        return len(self.queries)


def in_test_region(
    northing: float,
    easting: float,
    regions: Sequence[tuple[float, float]] = tuple(OXFORD_TEST_REGIONS),
    width: float = OXFORD_REGION_WIDTH,
) -> bool:
    """True inside a ±``width`` box around any region centre (``width`` is
    a half-width: a 300 m square at the default)."""
    for cn, ce in regions:
        if abs(northing - cn) < width and abs(easting - ce) < width:
            return True
    return False


def _in_regions(table: dict, regions, width: float = OXFORD_REGION_WIDTH) -> np.ndarray:
    """[rows] bool: which rows lie inside a held-out rectangle."""
    return np.array([in_test_region(n, e, regions, width)
                     for n, e in zip(table["northing"], table["easting"])], bool)


def any_in_test_regions(
    table: dict,
    regions: Sequence[tuple[float, float]] | None = None,
    width: float = OXFORD_REGION_WIDTH,
) -> bool:
    """Does any scanned submap fall inside the held-out rectangles? Drives
    the CLIs' ``only_test_regions=auto``: real Oxford data does, synthetic
    layouts do not."""
    regions = regions if regions is not None else OXFORD_TEST_REGIONS
    return bool(_in_regions(table, regions, width).any())


def take_rows(table: dict, rows) -> dict:
    """The table's rows ``rows`` (indices or a bool mask), in order."""
    rows = np.flatnonzero(rows) if np.asarray(rows).dtype == bool else np.asarray(rows, int)
    return {"file": [table["file"][i] for i in rows],
            "northing": np.asarray(table["northing"])[rows],
            "easting": np.asarray(table["easting"])[rows],
            "run": [table["run"][i] for i in rows]}


def concat_tables(tables: Sequence[dict]) -> dict:
    """One table of the rows of ``tables``, in order."""
    return {"file": [f for t in tables for f in t["file"]],
            "northing": np.concatenate([t["northing"] for t in tables]),
            "easting": np.concatenate([t["easting"] for t in tables]),
            "run": [r for t in tables for r in t["run"]]}


# 10**i for i <= 308, each the double nearest to it (C's 1e<i> literals)
_POW10 = [float(10 ** i) for i in range(309)]
_DIGITS = "0123456789"


def _parse_float(text: str) -> float:
    """A csv number as pandas' default C parser (``precise_xstrtod``) reads
    it: at most 17 significant digits accumulated in a double
    (``x = x * 10 + d``), then one multiplication or division by a power of
    ten. Strings without digits (``nan``, ``inf``) go to ``float``."""
    s = text.strip()
    p, end = 0, len(s)
    negative = p < end and s[p] == "-"
    if p < end and s[p] in "+-":
        p += 1
    number, exponent, num_digits, num_decimals = 0.0, 0, 0, 0
    start = p
    while p < end and s[p] in _DIGITS:
        if num_digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            num_digits += 1
        else:
            exponent += 1
        p += 1
    if p < end and s[p] == ".":
        p += 1
        while num_digits < 17 and p < end and s[p] in _DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            num_digits += 1
            num_decimals += 1
            p += 1
        while p < end and s[p] in _DIGITS:  # digits past the 17th
            p += 1
        exponent -= num_decimals
    if p == start or s[start:p] == ".":
        return float(s)
    if p < end and s[p] in "eE":
        q = p + 1
        sign = -1 if q < end and s[q] == "-" else 1
        if q < end and s[q] in "+-":
            q += 1
        n_exp, exp_digits = 0, 0
        while exp_digits < 17 and q < end and s[q] in _DIGITS:
            n_exp = n_exp * 10 + ord(s[q]) - 48
            exp_digits += 1
            q += 1
        if exp_digits:
            exponent += sign * n_exp
            p = q
    if p != end:
        raise ValueError(f"could not parse {text!r} as a number")
    if exponent > 308:
        number = float("inf")
    elif exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -308:  # subnormal
        number = 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    return -number if negative else number


def _read_run_csv(csv_path: str) -> tuple[list[str], np.ndarray, np.ndarray]:
    """(timestamps as strings, northing, easting) of one run's csv. The
    timestamp stays a string: file names may have leading zeros."""
    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        need = {"timestamp", "northing", "easting"}
        if not need.issubset(header):
            raise ValueError(f"{csv_path}: need columns {need}, got {header}")
        col = {name: header.index(name) for name in need}
        rows = [r for r in reader if r]
    return ([r[col["timestamp"]] for r in rows],
            np.array([_parse_float(r[col["northing"]]) for r in rows], np.float64),
            np.array([_parse_float(r[col["easting"]]) for r in rows], np.float64))


def scan_runs(
    dataset_root: str,
    runs_subdir: str = "oxford",
    pointcloud_dir: str | None = None,
    csv_name: str | None = None,
) -> dict:
    """All submaps of all runs: the table of ``COLUMNS``.

    When ``pointcloud_dir``/``csv_name`` are None they are found per run:
    the first ``pointcloud_*`` directory and ``pointcloud_*.csv`` file in
    name order (Oxford's pointcloud_20m_10overlap, the in-house regions'
    pointcloud_25m_*)."""
    base = os.path.join(dataset_root, runs_subdir)
    tables = []
    for run in sorted(os.listdir(base)):
        run_dir = os.path.join(base, run)
        if not os.path.isdir(run_dir):
            continue
        csv_file = csv_name
        if csv_file is None:
            cands = sorted(f for f in os.listdir(run_dir)
                           if f.startswith("pointcloud_") and f.endswith(".csv"))
            csv_file = cands[0] if cands else None
        pc_dir = pointcloud_dir
        if pc_dir is None:
            cands = sorted(d for d in os.listdir(run_dir)
                           if d.startswith("pointcloud_")
                           and os.path.isdir(os.path.join(run_dir, d)))
            pc_dir = cands[0] if cands else None
        if csv_file is None or pc_dir is None:
            continue
        csv_path = os.path.join(run_dir, csv_file)
        if not os.path.isfile(csv_path):
            continue
        stamps, northing, easting = _read_run_csv(csv_path)
        tables.append({"file": [os.path.join(runs_subdir, run, pc_dir, f"{t}.bin")
                                for t in stamps],
                       "northing": northing, "easting": easting,
                       "run": [run] * len(stamps)})
    if not tables:
        raise FileNotFoundError(f"no runs with a pointcloud_*.csv under {base}")
    return concat_tables(tables)


def _coords(table: dict) -> np.ndarray:
    return np.column_stack([np.asarray(table["northing"], np.float64),
                            np.asarray(table["easting"], np.float64)])


def construct_query_dict(
    table: dict,
    positive_radius: float = 10.0,
    negative_radius: float = 50.0,
    exclude_test_regions: bool = True,
    test_regions: Sequence[tuple[float, float]] | None = None,
) -> TrainingTuples:
    """Each submap's positives (within ``positive_radius``) and negatives
    (beyond ``negative_radius``), by a UTM KD-tree."""
    if exclude_test_regions:
        regions = test_regions if test_regions is not None else OXFORD_TEST_REGIONS
        table = take_rows(table, ~_in_regions(table, regions))

    coords = _coords(table)
    tree = cKDTree(coords)
    pos_lists = tree.query_ball_point(coords, r=positive_radius)
    nonneg_lists = tree.query_ball_point(coords, r=negative_radius)

    n = len(table["file"])
    queries = {}
    all_ids = set(range(n))
    for i in range(n):
        queries[i] = {
            "query": table["file"][i],
            "northing": float(table["northing"][i]),
            "easting": float(table["easting"][i]),
            "positives": sorted(int(j) for j in pos_lists[i] if j != i),
            "negatives": sorted(all_ids - {int(j) for j in nonneg_lists[i]}),
        }
    return TrainingTuples(queries)


def construct_query_and_database_sets(
    table: dict,
    test_positive_radius: float = 25.0,
    only_test_regions: bool = False,
    test_regions: Sequence[tuple[float, float]] | None = None,
):
    """Returns (database_sets, query_sets): lists, one per run in name
    order, of {idx: entry} dicts; each query entry maps a database run's
    index to the ground-truth database indices within
    ``test_positive_radius``.

    The database keeps every submap of a run; ``only_test_regions``
    restricts only the queries to the held-out rectangles. Ground truth is
    taken against each full run's KD-tree, so recall@top-1% sees the true
    database size."""
    regions = test_regions if test_regions is not None else OXFORD_TEST_REGIONS

    def entries_of(sub):
        return {i: {"query": sub["file"][i],
                    "northing": float(sub["northing"][i]),
                    "easting": float(sub["easting"][i])}
                for i in range(len(sub["file"]))}

    run_col = np.asarray(table["run"], dtype=object)
    database_sets, query_sets, trees = [], [], []
    for run in sorted(set(table["run"])):
        sub = take_rows(table, run_col == run)
        database_sets.append(entries_of(sub))
        trees.append(cKDTree(_coords(sub)))
        if only_test_regions:
            sub = take_rows(sub, _in_regions(sub, regions))
        query_sets.append(entries_of(sub))

    for qi, qset in enumerate(query_sets):
        if not qset:
            continue
        coords = np.array([[v["northing"], v["easting"]] for v in qset.values()])
        for di, tree in enumerate(trees):
            if di == qi:
                continue
            gt = tree.query_ball_point(coords, r=test_positive_radius)
            for i, hits in enumerate(gt):
                qset[i][di] = sorted(int(h) for h in hits)
    return database_sets, query_sets


def save_pickle(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)
