"""The readings that a cell's limits are set from: the numbers compared
by sound runs of the program on many seeds, and by the controls (the
reference put in the program's place in a lower precision, ``controls()``
of the cell's unit) on some of them.  Not run by the benchmark's runs.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        --control-seeds 1 2 3 [--units 1]

One JSON line a seed on standard output: the program's numbers after
``--units`` units at the cell's own size, and each control's where the
seed is one of ``--control-seeds``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent / "src"))


def readings(cell: dict, seed: int, units: int, control: bool,
             device: str = "cuda") -> dict:
    import torch
    import workload as wl
    t0 = time.perf_counter()
    unit = wl.make_unit(cell["config"], cell["traffic"], seed, device)
    for _ in range(units):
        unit.keep(unit.run())
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    numbers, failed, info = unit.check(cell["limits"])
    t2 = time.perf_counter()
    row = {"seed": seed, "numbers": numbers, "failed": failed, "info": info,
           "unit_s": (t1 - t0) / units, "check_s": t2 - t1}
    if control:
        row["controls"] = unit.controls()
        row["control_s"] = time.perf_counter() - t2
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--units", type=int, default=1)
    args = p.parse_args(argv)
    import torch
    import workload as wl
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.kernels import _build
    _build.lib()
    cell = wl.load_cell(args.workload)
    for seed in args.seeds:
        row = readings(cell, seed, args.units, seed in args.control_seeds)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
