#!/usr/bin/env python3
"""Time the serving path of two or more checkouts of the repo on one GPU.

    python3 tools/serve_ab.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout.  The trees run in the order given,
each in a process of its own that builds that tree's kernels, imports its
``chip_smoke.py`` and runs its ``[serve]`` phase: qwen2-0.5b at its
published widths, seeded weights quantized to p16e1 on the kernel backend,
the paged p16e1 KV pool, the seeded trace replayed batched and
sequentially (``SERVE_*`` constants), with all of that phase's checks.
Give them as A B B A to cancel drift.  One JSON line per process (decode
step and prefill-token ms on the host clock, tok/s of both replays, the
profiled busy share, the phase's wall), then a summary line; the card's
``nvidia-smi`` name and power limit are printed beside them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
_build.lib()
dev = torch.device("cuda", 0)
smi = cs.nvidia_smi_line()
serve, counts = cs.phase_serve(dev, smi)
print("SERVE_AB " + json.dumps(dict(
    decode_step_ms=serve["decode_step_ms"],
    prefill_ms_per_token=serve["prefill_ms_per_token"],
    tok_s=serve["batched"]["tok_s"], seq_tok_s=serve["sequential"]["tok_s"],
    busy=(serve["profile"] or {}).get("busy"), wall_s=serve["wall_s"],
    launches={k: v for k, v in counts.items() if v}, device=smi)))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)
    rows = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                              capture_output=True, text=True, timeout=1200)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("SERVE_AB ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            raise SystemExit(f"{tree}: [serve] failed (rc {proc.returncode})")
        row = dict(tree=tree, **json.loads(line[len("SERVE_AB "):]))
        rows.append(row)
        print(json.dumps(row), flush=True)
    by_tree: dict[str, list] = {}
    for r in rows:
        by_tree.setdefault(r["tree"], []).append(r)
    summary = {t: {k: sum(r[k] for r in rs) / len(rs)
                   for k in ("decode_step_ms", "prefill_ms_per_token",
                             "tok_s", "seq_tok_s")}
               for t, rs in by_tree.items()}
    print(json.dumps(dict(summary=summary, device=rows[0]["device"])))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
