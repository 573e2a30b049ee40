"""End-to-end training at ~100M parameters on the PyTorch/CUDA port: the
port of ``examples/train_100m.py``.

A qwen2-family config scaled to ~100M params, trained on the synthetic
pipeline with checkpointing (the checkpoints are in the JAX package's
on-disk form):

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 150] \
        [--device cpu]

``--layers``, ``--d-model`` and ``--vocab`` shrink the model (the heads
stay 64 wide, d_ff = 4 d_model).  Runs on the GPU unless ``--device
cpu`` is given, and raises when torch sees no GPU.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch import _device
from repro_torch.configs import get_config
from repro_torch.launch.train import run
from repro_torch.models import init_params
from repro_torch.tree import leaves


def config_100m(n_layers=8, d_model=512, vocab=32000):
    base = get_config("qwen2-0.5b")
    return dataclasses.replace(
        base, name="qwen2-100m", n_layers=n_layers, d_model=d_model,
        n_heads=d_model // 64, n_kv_heads=2, d_head=64, d_ff=4 * d_model,
        vocab=vocab)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "ckpt_100m"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=32000)
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)
    cfg = config_100m(args.layers, args.d_model, args.vocab)
    n = sum(leaf.numel() for leaf in leaves(
        init_params(0, cfg, device="meta")))
    print(f"[100m] param count: {n/1e6:.1f}M")
    import repro_torch.launch.train as T
    import repro_torch.configs as C
    orig = C.get_smoke_config
    C.get_smoke_config = lambda a: cfg          # route the driver to 100M
    T.get_smoke_config = lambda a: cfg
    try:
        _, _, losses = run("qwen2-100m", smoke=True, steps=args.steps,
                           batch=2, seq=128, lr=6e-4,
                           ckpt_dir=args.ckpt_dir, ckpt_every=50,
                           log_every=10, device=device)
    finally:
        C.get_smoke_config = orig
        T.get_smoke_config = orig
    print(f"[100m] loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps")
    return dict(params=n, losses=losses)


if __name__ == "__main__":
    main()
