"""Quickstart on the PyTorch/CUDA port: posit arithmetic, the paper's
linear-algebra stack, the golden-zone accuracy effect, choosing a posit
format, quire-exact least squares, observability, and posit-quantized
serving.  The port of ``examples/quickstart.py``; the GEMM of section 2
with ``backend="pallas_split3"`` runs the port's hand-written Hopper
kernel (decode pre-pass + tiled GEMM with the posit encode fused into
its epilogue).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the GPU unless ``--device cpu`` is given (the plain PyTorch
versions of the kernels), and raises when torch sees no GPU.
"""
import argparse

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import posit as P
from repro_torch.kernels.ops import rgemm
from repro_torch.lapack.error_eval import backward_error_study


def _f64(p) -> np.ndarray:
    return P.to_float64(p).cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=64,
                    help="GEMM and study size, least-squares columns")
    ap.add_argument("--m", type=int, default=96, help="least-squares rows")
    ap.add_argument("--nb", type=int, default=16, help="block size")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    n, nb = args.n, args.nb
    out = {}

    # --- 1. posit scalars/vectors ---------------------------------------
    x = np.array([1.0, 3.141592653589793, -0.001, 1e6])
    xt = torch.from_numpy(x).to(dev)
    px = P.from_float64(xt)                     # int32 posit words
    s = P.add(px, px)
    out["words"] = px.cpu().numpy()
    out["decoded"] = _f64(px)
    out["rel_eps"] = P.rounding_eps(xt).cpu().numpy()
    out["sum_words"] = s.cpu().numpy()
    out["sum"] = _f64(s)
    print("posit32 words:", [hex(w) for w in out["words"].view(np.uint32)])
    print("decoded:      ", out["decoded"])
    print("rel eps:      ", out["rel_eps"],
          " (binary32 eps ~ 6e-8; inside the golden zone posit is finer)")
    print("x + x:        ", out["sum"])

    # --- 2. posit GEMM (the paper's accelerator op) ----------------------
    rng = np.random.default_rng(0)
    a = P.from_float64(torch.from_numpy(rng.standard_normal((n, n))).to(dev))
    b = P.from_float64(torch.from_numpy(rng.standard_normal((n, n))).to(dev))
    gemms = {"quire": rgemm(a, b, backend="xla_quire"),  # f64 dot, 1 rounding
             "faithful": rgemm(a, b, backend="faithful"),  # per-MAC rounding
             # the Hopper kernel (the plain PyTorch version on the CPU)
             "pallas": rgemm(a, b, backend="pallas_split3")}
    truth = _f64(a) @ _f64(b)
    out["gemm_a"], out["gemm_b"] = a.cpu().numpy(), b.cpu().numpy()
    out["gemm_words"] = {k: c.cpu().numpy() for k, c in gemms.items()}
    out["gemm_err"] = {}
    for name, c in gemms.items():
        err = float(np.abs(_f64(c) - truth).max())
        out["gemm_err"][name] = err
        print(f"GEMM[{name:8s}] max abs err vs f64: {err:.3e}")

    # --- 3. the paper's headline: golden-zone accuracy -------------------
    out["lu"] = {}
    for sigma in (1.0, 1e6):
        r = backward_error_study(n, sigma, "lu", nb=nb,
                                 gemm_backend="faithful", device=dev)
        out["lu"][sigma] = r
        print(f"LU sigma={sigma:g}: posit beats binary32 by "
              f"{r.digits:+.2f} digits of backward error")

    # --- 4. choosing a format --------------------------------------------
    # The whole stack is format-parametric (fmt= on rgemm, the
    # factorizations, the solves and the refinement drivers): p32e2 for
    # accuracy, p16e1 as the factorization format of mixed-precision
    # solves, p8e2 for storage experiments.  Same matrix, three formats:
    from repro_torch.core.formats import P16E1, P8E2, P32E2
    out["formats"] = {}
    for fmt in (P32E2, P16E1, P8E2):
        r = backward_error_study(n, 1.0, "lu", nb=nb,
                                 gemm_backend="xla_quire", fmt=fmt,
                                 device=dev)
        out["formats"][fmt.name] = r
        print(f"LU in {fmt.name}: backward error {r.e_posit:.2e} "
              f"({r.digits:+.2f} digits vs binary32)")

    # --- 5. least squares (over-determined systems) ----------------------
    # Householder QR: rgels solves min ||A x - b|| via x = R^{-1} (Q^T b);
    # rgels_ir refines with quire-exact residuals onto the least-squares
    # optimum of the posit-held problem.
    from repro_torch.lapack import rgels, rgels_ir
    from repro_torch.lapack.refine import pair_to_float64

    m = args.m
    a64 = rng.standard_normal((m, n))
    b64 = a64 @ np.full(n, 1.0 / np.sqrt(n))
    ap_ = P.from_float64(torch.from_numpy(a64).to(dev))
    bp_ = P.from_float64(torch.from_numpy(b64).to(dev))
    aq, bq = _f64(ap_), _f64(bp_)
    x_plain, _ = rgels(ap_, bp_, nb=nb)
    (x_hi, x_lo), _ = rgels_ir(ap_, bp_, iters=3, nb=nb)
    out["ls"] = {}
    for name, xs in [("rgels", _f64(x_plain)),
                     ("rgels_ir", pair_to_float64(x_hi, x_lo).cpu().numpy())]:
        e = float(np.linalg.norm(bq - aq @ xs) / np.linalg.norm(bq))
        out["ls"][name] = e
        print(f"LS {name:9s} m={m} n={n}: backward error {e:.2e}")
    e_opt = float(np.linalg.norm(
        bq - aq @ np.linalg.lstsq(aq, bq, rcond=None)[0]) / np.linalg.norm(bq))
    out["ls"]["optimum"] = e_opt
    print(f"LS optimum (f64 lstsq on the same posit-held data): {e_opt:.2e}")

    # --- 6. observability (positscope) -----------------------------------
    # Open a scope and every instrumented call underneath records
    # golden-zone occupancy, per-sweep refinement convergence and spans;
    # with no scope open nothing is recorded.
    from repro_torch import obs
    from repro_torch.lapack import rgesv_ir

    bp_sq = P.from_float64(torch.from_numpy(a64[:n, 0]).to(dev))
    with obs.scoped() as mtr:
        rgesv_ir(P.from_float64(torch.from_numpy(a64[:n, :n]).to(dev)),
                 bp_sq, iters=3, nb=nb)
    d = mtr.to_dict()
    out["observed"] = d
    print(f"observed: A golden-zone "
          f"{d['gauges']['rgetrf.last_panel.golden_zone']:.2f}, "
          f"{int(d['counters']['ir.sweeps'])} IR sweeps, "
          f"last ||r|| {d['series']['ir.sweep'][-1]['r_norm']:.1e}, "
          f"{d['spans']} spans  (mtr.save_chrome_trace(...) -> Perfetto)")

    # --- 7. posit-quantized serving --------------------------------------
    # Weights as p16e1 words with per-channel pow2 equilibration; the
    # engine's KV cache lives in paged posit pools (torch_serve_posit.py).
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import init_params
    from repro_torch.serving import QuantConfig, param_bytes, quantize_params

    cfg = get_tiny_config("qwen2-0.5b", policy="f32")
    qp = quantize_params(init_params(0, cfg, device=dev),
                         QuantConfig(fmt="p16e1"))
    pb = param_bytes(qp)
    out["weight_ratio"] = pb["q_f32_bytes"] / pb["word_bytes"]
    print(f"qwen2 weights as p16e1: {out['weight_ratio']:.1f}x smaller")
    return out


if __name__ == "__main__":
    main()
