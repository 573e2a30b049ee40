"""End-to-end training driver (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen2-0.5b --smoke --steps 200
    # kill it at any point, then resume from the latest checkpoint:
    python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \\
        --steps 200 --ckpt-dir CKPT

Runs on the card unless ``--device cpu`` is given, and never switches
on its own.  The data is a pure function of (seed, step), and the
checkpoint holds the whole training state (params, AdamW moments, step)
in the reference's on-disk form and stacked layout
(``interop.train_state_to_reference``), so a restarted run continues the
same stream, and a checkpoint of either package resumes in the other.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch import _device, interop
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ShapeCell, get_config, get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim import adamw_init


def run(arch: str, smoke: bool = True, steps: int = 50, batch: int = 4,
        seq: int = 64, ckpt_dir: str | None = None, ckpt_every: int = 20,
        lr: float = 1e-3, seed: int = 0, log_every: int = 10,
        policy: str | None = None, device="cuda", on_step=None):
    """Train ``steps`` steps (from the latest checkpoint in ``ckpt_dir``
    when there is one); returns (params, opt_state, losses of the steps
    run here).  ``on_step(step, metrics)``, if given, is called after
    every step."""
    dev = _device.resolve(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if policy:
        cfg = dataclasses.replace(cfg, policy=policy)
    cell = ShapeCell("e2e", "train", seq, batch)
    compress = cfg.get_policy().opt_compression is not None

    params = init_params(seed, cfg, device=dev)
    opt = adamw_init(params, compress_moments=compress)
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        like = interop.train_state_to_reference(params, opt, cfg)
        state, start, _ = restore_checkpoint(ckpt_dir, like)
        params, opt = interop.train_state_from_reference(state, cfg, dev)
        print(f"[train] resumed from step {start}")

    step_fn = make_train_step(cfg, remat=False, lr=lr)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        batch_data = make_batch(cfg, cell, step, seed=seed,
                                batch_override=batch, device=dev)
        params, opt, metrics = step_fn(params, opt, batch_data)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step, metrics)
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt:.1f}s)", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1,
                            interop.train_state_to_reference(params, opt,
                                                             cfg),
                            extra={"arch": arch, "loss": losses[-1]})
    return params, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--policy", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (default) or cpu")
    args = ap.parse_args(argv)
    _, _, losses = run(args.arch, smoke=args.smoke, steps=args.steps,
                       batch=args.batch, seq=args.seq,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       lr=args.lr, seed=args.seed, policy=args.policy,
                       device=args.device)
    if losses:
        print(f"[train] first loss {losses[0]:.4f} -> last loss "
              f"{losses[-1]:.4f}")


if __name__ == "__main__":
    main()
