#!/usr/bin/env python3
"""Run the port's example scripts on one GPU with the card to themselves.

    python3 tools/examples_alone.py [NAME ...] [--out FILE]

``chip_smoke.py``'s ``[examples]`` runs the ten ``examples/torch_<name>.py``
in child processes beside other phases, so the walls it prints are taken
with the card shared.  This tool runs the named scripts (all ten by
default) one after another in this process, through the same
``chip_smoke.run_examples``: the same arguments (``EXAMPLE_ARGS``), launch
counts and checks.  It prints one line a script (wall on the host clock,
a device sync around ``main()``, and its launches) and the card's
``nvidia-smi`` name and power limit.  Run it after ``chip_smoke.py`` in
the same call, so that the kernels load from its build.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="examples (default: all ten)")
    ap.add_argument("--out", help="also write the reports as JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("examples_alone: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    smi = cs.nvidia_smi_line()
    report = cs.run_examples(torch.device("cuda", 0),
                             args.names or list(cs.EXAMPLE_ARGS))
    for name, r in report.items():
        launched = {k: v for k, v in r["launches"].items() if v}
        print(f"[alone] {' '.join([name, *r['argv']])}: wall "
              f"{r['wall_s']:.2f} s; launches {launched}; {r['summary']}")
    total = sum(r["wall_s"] for r in report.values())
    print(f"[alone] {len(report)} scripts in {total:.2f} s [{smi}]")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(device=smi, total_s=total,
                                                  examples=report), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
