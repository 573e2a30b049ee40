"""Reproduce paper Fig. 7 (the accuracy headline) across sigma, on the
PyTorch/CUDA port: the port of ``examples/cholesky_lu_accuracy.py``.

    PYTHONPATH=src python examples/torch_cholesky_lu_accuracy.py [--device cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises when torch
sees no GPU.
"""
import argparse

from repro_torch.lapack.error_eval import backward_error_study


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=64, help="matrix size")
    ap.add_argument("--nb", type=int, default=16, help="block size")
    args = ap.parse_args(argv)
    print(f"{'algo':10s} {'sigma':>8s} {'e_posit':>12s} {'e_binary32':>12s} "
          f"{'digits':>8s}")
    out = {}
    for algo in ("cholesky", "lu"):
        for sigma in (1e-2, 1.0, 1e2, 1e4):
            r = backward_error_study(args.n, sigma, algo, nb=args.nb,
                                     gemm_backend="faithful",
                                     device=args.device)
            out[algo, sigma] = r
            print(f"{algo:10s} {sigma:8g} {r.e_posit:12.3e} "
                  f"{r.e_binary32:12.3e} {r.digits:+8.2f}")
    print("\npositive digits = Posit(32,2) more accurate than binary32 "
          "(paper: ~+0.5 Cholesky / ~+0.8 LU in the golden zone)")
    return out


if __name__ == "__main__":
    main()
