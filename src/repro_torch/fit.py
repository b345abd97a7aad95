"""``repro_torch.fit``: the command line over the calibration fitter,
ported from the reference's ``fit.py`` (:mod:`repro_torch.core.calibrate`
is the implementation; this module re-exports it)::

    # fit from a run's JSONL stream (and optionally its snapshot)
    python -m repro_torch.fit RUN/train.jsonl \
        --snapshot RUN/BENCH_step_metrics.json --out RUN/calibration.json

    # plan and measure again with the fitted table
    python -m repro_torch.launch.train --arch qwen2-0.5b ... \
        --calibration RUN/calibration.json
"""

from __future__ import annotations

from repro_torch.core.calibrate import (  # noqa: F401  (public re-exports)
    CALIBRATION_VERSION, CalibrationDataError, CalibrationTable,
    CalibrationWarning, active, cell_from_meta, fit, fit_device_flops,
    fit_from_files, fit_link, fit_memory_scale, fit_pipe, links, load,
    predicted_step_seconds_for_cell, set_active)

__all__ = [
    "CALIBRATION_VERSION", "CalibrationTable", "CalibrationWarning",
    "CalibrationDataError", "fit", "fit_from_files", "fit_link",
    "fit_pipe", "fit_memory_scale", "fit_device_flops", "cell_from_meta",
    "predicted_step_seconds_for_cell", "load", "set_active", "active",
    "links", "main",
]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fit",
        description="least-squares-refit planner cost/memory constants "
                    "from obs JSONL streams + BENCH snapshots")
    ap.add_argument("jsonl", nargs="+",
                    help="obs JSONL stream(s) from a --metrics run")
    ap.add_argument("--snapshot", default=None, metavar="BENCH.json",
                    help="snapshot to locate the cell / steady-state "
                         "histograms (default: the stream's final metrics "
                         "document)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the fitted table here (JSON)")
    args = ap.parse_args(argv)

    table = fit_from_files(args.jsonl, snapshot_path=args.snapshot)
    print(table.describe())
    prov = dict(table.provenance)
    for k, v in sorted(prov.get("residuals", {}).items()):
        print(f"  residual {k}: {v:.4g}")
    for w in prov.get("warnings", []):
        print(f"  warning [{w['field']}]: {w['reason']}")
    if args.out:
        print(f"wrote {table.save(args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
