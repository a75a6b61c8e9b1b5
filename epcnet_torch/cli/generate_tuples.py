"""Tuple and test-set generation CLI (twin of
``epcnet_tpu/cli/generate_tuples.py``; the same flags, pickles and paths):

  python -m epcnet_torch.cli.generate_tuples --dataset_root D --mode baseline
  python -m epcnet_torch.cli.generate_tuples --dataset_root D --mode refine \\
      --runs_subdirs oxford university residential business
  python -m epcnet_torch.cli.generate_tuples --dataset_root D --mode test
  python -m epcnet_torch.cli.generate_tuples --dataset_root D --synthetic

numpy and scipy only; nothing runs on the card.
"""

from __future__ import annotations

import argparse
import os

from epcnet_torch.data.synthetic import generate_synthetic_dataset
from epcnet_torch.data.tuples import (
    any_in_test_regions,
    concat_tables,
    construct_query_and_database_sets,
    construct_query_dict,
    save_pickle,
    scan_runs,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--runs_subdir", default="oxford")
    ap.add_argument(
        "--runs_subdirs", nargs="*", default=None,
        help="refine mode: region subdirs merged into ONE training set "
        "(e.g. oxford university residential business); default: runs_subdir",
    )
    # None = found per run (oxford uses pointcloud_20m_10overlap*, the
    # in-house regions pointcloud_25m_*; scan_runs handles both)
    ap.add_argument("--pointcloud_dir", default=None)
    ap.add_argument("--csv_name", default=None)
    ap.add_argument("--mode", choices=["baseline", "refine", "test"], default="baseline")
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--positive_radius", type=float, default=10.0)
    ap.add_argument("--negative_radius", type=float, default=50.0)
    ap.add_argument("--test_positive_radius", type=float, default=25.0)
    ap.add_argument(
        "--only_test_regions", choices=["auto", "true", "false"], default="auto",
        help="mode=test: restrict QUERIES to the held-out rectangles (the "
        "database always keeps full runs); auto = filter iff the scanned "
        "runs intersect the rectangles (real Oxford yes, synthetic no)",
    )
    ap.add_argument("--synthetic", action="store_true",
                    help="first generate a synthetic dataset at dataset_root")
    ap.add_argument("--synthetic_runs", type=int, default=3)
    ap.add_argument("--synthetic_submaps", type=int, default=40)
    ap.add_argument("--synthetic_hard", action="store_true",
                    help="hard mode: each visit re-samples points from the "
                    "place's blob layout (shared structure, disjoint points)")
    ap.add_argument("--synthetic_difficulty", type=float, default=0.0,
                    help="benchmark dial in [0, 1]: per-visit heading "
                    "rotation, blob occlusion, resampling + noise")
    ap.add_argument("--num_points", type=int, default=4096)
    args = ap.parse_args(argv)

    if args.synthetic:
        # the scan flags default to None (found per run); the generator
        # needs concrete names, so it takes the oxford-style defaults
        generate_synthetic_dataset(
            args.dataset_root, args.synthetic_runs, args.synthetic_submaps,
            args.num_points, args.runs_subdir,
            args.pointcloud_dir or "pointcloud_20m_10overlap",
            args.csv_name or "pointcloud_locations_20m_10overlap.csv",
            resample_per_visit=args.synthetic_hard,
            difficulty=args.synthetic_difficulty,
        )
    out_dir = args.output_dir or args.dataset_root
    if args.mode == "refine":
        # the refine protocol merges the in-house regions' runs with the
        # baseline region into ONE training set; the held-out rectangles
        # still exclude training submaps
        subdirs = args.runs_subdirs or [args.runs_subdir]
        table = concat_tables([
            scan_runs(args.dataset_root, sd, args.pointcloud_dir, args.csv_name)
            for sd in subdirs
        ])
    else:
        table = scan_runs(args.dataset_root, args.runs_subdir, args.pointcloud_dir,
                          args.csv_name)

    if args.mode in ("baseline", "refine"):
        tt = construct_query_dict(
            table, args.positive_radius, args.negative_radius, exclude_test_regions=True,
        )
        path = os.path.join(out_dir, f"training_queries_{args.mode}.pickle")
        save_pickle(tt.queries, path)
        print(f"wrote {len(tt.queries)} tuples -> {path}")
    else:
        only_test = {
            "auto": any_in_test_regions(table), "true": True, "false": False,
        }[args.only_test_regions]
        db_sets, q_sets = construct_query_and_database_sets(
            table, args.test_positive_radius, only_test_regions=only_test
        )
        dbp = os.path.join(out_dir, f"{args.runs_subdir}_evaluation_database.pickle")
        qp = os.path.join(out_dir, f"{args.runs_subdir}_evaluation_query.pickle")
        save_pickle(db_sets, dbp)
        save_pickle(q_sets, qp)
        print(f"wrote {len(db_sets)} runs -> {dbp}, {qp}")


if __name__ == "__main__":
    main()
