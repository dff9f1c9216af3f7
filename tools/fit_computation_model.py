#!/usr/bin/env python
"""Fit a ComputationModel from profiled factor timings on the device.

The counterpart of the reference's bench -Z -> opt_comp_model auto-tuning
loop (examples/OptimizeCompModel.cpp): run representative problems with
per-op profiling, least-squares fit the polynomial op models, and print
copy-pasteable Python constants for computation_model.py. The resulting
model drives the supernode-merge heuristic.

Usage: python tools/fit_computation_model.py [--sizes 300 600 1000]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[200, 500, 1000])
    ap.add_argument("--fills", type=float, nargs="+", default=[0.05, 0.1])
    ap.add_argument("--csv", default=None,
                    help="fit from a bench.py --csv dump instead of "
                         "profiling in-process (the reference's "
                         "bench -Z -> opt_comp_model flow)")
    args = ap.parse_args()

    from baspacho_tpu import BackendType, Settings, create_solver
    from baspacho_tpu.stats import fit_computation_model, profile_factor
    from baspacho_tpu.testing import SparseMatGenerator, random_spd_data

    if args.csv:
        records = []
        with open(args.csv) as fh:
            next(fh)  # header
            for line in fh:
                op, a, b, c, t = line.strip().split(",")
                records.append((op, float(a), float(b), float(c),
                                float(t)))
        _emit(fit_computation_model(records))
        return

    # a rich fit basis needs buckets of many shapes (cp, rp, B): flats
    # merge down to a couple of big lumps (few samples), so mix in grid
    # and meridian topologies whose schedules keep dozens of levels of
    # varied supernode shapes (the reference's bench -Z likewise sweeps
    # its problem generators, Bench.cpp:290-358)
    problems = []
    for n in args.sizes:
        for fill in args.fills:
            problems.append((f"flat{n}/{fill}",
                             SparseMatGenerator.gen_flat(n, fill, seed=37)))
    for w in (20, 40, 60):
        problems.append((f"grid{w}",
                         SparseMatGenerator.gen_grid(w, w, 0.25)))
    problems.append(("meri3", SparseMatGenerator.gen_meridians(
        3, 60, 0.4, 2, 60, 20, 20, seed=19)))

    records = []
    for name, gen in problems:
        ss = gen.to_structure()
        n = ss.order
        solver = create_solver(
            Settings(backend=BackendType.PLANNED), np.full(n, 3), ss)
        data = random_spd_data(solver.data_size, solver.order, 0,
                               np.float32)
        data = np.asarray(solver.skel.damp(data, 0.0,
                                           solver.order * 1.5),
                          dtype=np.float32)
        rec = profile_factor(solver, data)
        print(f"{name}: {len(rec)} samples", file=sys.stderr)
        records.extend(rec)

    _emit(fit_computation_model(records))


def _emit(cm):
    print("# fitted ComputationModel (paste into computation_model.py):")
    print("model_fitted = ComputationModel(")
    print(f"    potrf_params={cm.potrf_params.tolist()},")
    print(f"    trsm_params={cm.trsm_params.tolist()},")
    print(f"    syge_params={cm.syge_params.tolist()},")
    print(f"    asmbl_params={cm.asmbl_params.tolist()},")
    print(")")


if __name__ == "__main__":
    main()
