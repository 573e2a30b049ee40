"""Train a small LM end-to-end with posit numeric policies, on the
PyTorch/CUDA port: the port of ``examples/posit_training.py``.

Compares three numeric policies on the same model/data:
  bf16        — baseline
  posit32     — paper-faithful QAT (weights+activations on the p32
                lattice; on the GPU through the port's encode and decode
                kernels)
  bf16_opt16  — posit16-compressed optimizer moments (golden-zone
                re-centering; what makes llama3-405b fit 512 chips)

    PYTHONPATH=src python examples/torch_posit_training.py [--device cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises when torch
sees no GPU.
"""
import argparse

from repro_torch.launch.train import run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    out = {}
    for policy in ("bf16", "posit32", "bf16_opt16"):
        print(f"\n=== policy = {policy} ===")
        _, _, losses = run("qwen2-0.5b", smoke=True, steps=args.steps,
                           batch=4, seq=64, lr=1e-3, policy=policy,
                           log_every=10, device=args.device)
        out[policy] = losses
        print(f"policy {policy}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
