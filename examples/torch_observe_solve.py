"""positscope walkthrough on the PyTorch/CUDA port: watch a
mixed-precision solve converge.  The port of ``examples/observe_solve.py``.

Runs ``rgesv_mp`` (p16e1 factorization + p32e2 quire-exact refinement)
over the paper's §5.1 sigma grid with the observability layer on:

* per-sweep convergence trace — residual norm, digits gained, and the
  golden-zone occupancy of the residual (the ``ir.sweep`` series);
* operand golden-zone occupancy per sigma — the measurable mechanism
  behind the paper's "accuracy depends on operand scale" effect
  (posit(32,2) keeps its maximal 27 fraction bits only for
  |x| in [1/16, 16));
* a Chrome trace_event file (``--trace``, TRACE_observe_solve.json by
  default) — open it in Perfetto (https://ui.perfetto.dev) or
  chrome://tracing to see the factorization / sweep span timeline.

    PYTHONPATH=src python examples/torch_observe_solve.py [--device cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises when torch
sees no GPU.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch import _device, obs
from repro_torch.core import posit as P
from repro_torch.core.formats import P16E1, P32E2
from repro_torch.lapack.refine import pair_to_float64, rgesv_mp


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=64, help="matrix size")
    ap.add_argument("--trace", default="TRACE_observe_solve.json",
                    help="where to write the Chrome trace")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    # --- the §5.1 protocol over a sigma grid -----------------------------
    # x_sol = (1/sqrt(n)) ones, b = A x_sol in f64; solve the posit-held
    # system and measure the backward error against what the solver saw.
    n = args.n
    sigmas = (1e-4, 1e-2, 1.0, 1e2, 1e4)
    rng = np.random.default_rng(0)

    lo, hi = obs.golden_zone_bounds(P32E2)
    lo16, hi16 = obs.golden_zone_bounds(P16E1)
    print(f"golden zone of {P32E2.name}: |x| in [{lo:g}, {hi:g})   "
          f"(factor format {P16E1.name}: [{lo16:g}, {hi16:g}))\n")

    collector = obs.Collector()
    out = {"sigmas": {}}
    seen = 0                    # ir.sweep rows of the earlier sigmas
    for sigma in sigmas:
        a64 = rng.standard_normal((n, n)) * sigma + n * sigma * np.eye(n)
        b64 = a64 @ np.full(n, 1.0 / np.sqrt(n))
        a_p = P.from_float64(torch.from_numpy(a64).to(dev))
        b_p = P.from_float64(torch.from_numpy(b64).to(dev))

        with obs.scoped(collector) as m:
            with obs.span("solve", sigma=sigma):
                (x_hi, x_lo), _ = rgesv_mp(a_p, b_p, iters=6, nb=16)

        occ = obs.golden_zone_fraction(a_p)
        a64q = P.to_float64(a_p).cpu().numpy()
        b64q = P.to_float64(b_p).cpu().numpy()
        x = pair_to_float64(x_hi, x_lo).cpu().numpy()
        err = float(np.linalg.norm(b64q - a64q @ x) / np.linalg.norm(b64q))
        print(f"sigma={sigma:<8g} golden-zone occupancy of A: {occ:5.3f}   "
              f"backward error after refinement: {err:.2e}")
        rows = m.to_dict()["series"]["ir.sweep"]
        for row in rows:
            print(f"    sweep {row['sweep']}: ||r|| = {row['r_norm']:.3e}   "
                  f"digits gained {row['digits_gained']:+5.2f}   "
                  f"r golden-zone {row['golden_frac']:.3f}   "
                  f"quire carries {row['limb_carries']}")
        out["sigmas"][sigma] = dict(a_words=a_p.cpu().numpy(), occupancy=occ,
                                    error=err, sweeps=rows[seen:])
        seen = len(rows)

    # --- dump the span timeline ------------------------------------------
    collector.save_chrome_trace(args.trace)
    with open(args.trace) as f:
        out["trace_events"] = len(json.load(f)["traceEvents"])
    print(f"\nwrote {args.trace} ({out['trace_events']} span events) — load "
          "it in Perfetto (ui.perfetto.dev) or chrome://tracing")
    return out


if __name__ == "__main__":
    main()
