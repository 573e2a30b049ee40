#!/usr/bin/env python3
"""Numbers behind the port's QR cells that a CPU run can give.

    PYTHONPATH=src python tools/qr_reference_numbers.py [--skip-reference]

1. The JAX package's plain least-squares solve (``repro.lapack.qr.rgels``,
   nb=32) on the cells of ``chip_smoke.py``'s ``[qr]`` and ``[lstsq]``
   phases, with the ``xla_quire`` and ``pallas_split3`` GEMM backends: the
   backward error e_qr of each against the posit-held (A, b), and how many
   decimal digits apart they are.  With ``pallas_split3`` the block
   reflector's W = V^T C takes the fused-encode form, rounded from the f32
   accumulator, which is why the two differ.  (Accuracy, not time: the
   JAX package runs here on the CPU, in interpret mode for the kernel.)
2. The port's sequential work in the same solve: how many times
   ``rgels`` calls ``chain_round`` (each a few dozen elementwise ops, so a
   few dozen kernel launches on a GPU), counted on the CPU.

It takes a few minutes, most of it the JAX package compiling.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

CELLS = ((96, 64), (384, 256))
SIGMAS = (1e-2, 1.0, 1e2)


def backward_error(a64, x64, b64):
    return float(np.linalg.norm(b64 - a64 @ x64) / np.linalg.norm(b64))


def reference_errors():
    import jax.numpy as jnp
    from repro.core import posit as P
    from repro.lapack import qr
    from repro.lapack.error_eval import make_rect
    for m, n in CELLS:
        for sigma in SIGMAS:
            a64 = make_rect(m, n, sigma, 0)
            b64 = a64 @ np.full(n, 1.0 / np.sqrt(n))
            a = P.from_float64(jnp.asarray(a64))
            b = P.from_float64(jnp.asarray(b64))
            aq, bq = np.asarray(P.to_float64(a)), np.asarray(P.to_float64(b))
            err = {}
            for backend in ("xla_quire", "pallas_split3"):
                x, _ = qr.rgels(a, b, nb=32, gemm_backend=backend)
                err[backend] = backward_error(
                    aq, np.asarray(P.to_float64(x)), bq)
            gap = np.log10(err["pallas_split3"] / err["xla_quire"])
            print(f"JAX package rgels {(m, n)} sigma={sigma:g} nb=32: e_qr "
                  f"xla_quire {err['xla_quire']!r}, pallas_split3 "
                  f"{err['pallas_split3']!r} ({gap:.4f} digits above)",
                  flush=True)


def port_chain_roundings():
    import torch
    from repro_torch.core import posit
    from repro_torch.lapack import qr
    from repro_torch.lapack.error_eval import make_rect
    calls = [0]
    plain = posit.chain_round

    def counted(x, fmt=posit.P32E2):
        calls[0] += 1
        return plain(x, fmt)
    posit.chain_round = counted
    try:
        for m, n in CELLS:
            a64 = make_rect(m, n, 1.0, 0)
            b64 = a64 @ np.full(n, 1.0 / np.sqrt(n))
            calls[0] = 0
            qr.rgels(posit.from_float64(torch.from_numpy(a64)),
                     posit.from_float64(torch.from_numpy(b64)), nb=32,
                     gemm_backend="pallas_split3")
            print(f"port rgels {(m, n)} nb=32: {calls[0]} chain_round "
                  "calls", flush=True)
    finally:
        posit.chain_round = plain


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-reference", action="store_true",
                    help="count the port's roundings only (no JAX)")
    args = ap.parse_args()
    port_chain_roundings()
    if not args.skip_reference:
        reference_errors()


if __name__ == "__main__":
    main()
