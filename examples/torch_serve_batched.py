"""Batched serving on the PyTorch/CUDA port: prefill + greedy decode over
the ring-buffer KV/state caches, on two architecture families (attention
+ SSM).  The port of ``examples/serve_batched.py``.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

The weights are the port's own, made from a seed (so the tokens differ
from the JAX example's).  Runs on the GPU unless ``--device cpu`` is
given, and raises when torch sees no GPU.
"""
import argparse

import numpy as np

from repro_torch import _device
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serving import generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    out = {}
    for arch in ("qwen2-0.5b", "mamba2-780m"):
        cfg = get_smoke_config(arch)
        params = init_params(0, cfg, device=dev)
        prompts = np.array([[5, 6, 7, 8], [1, 2, 3, 4]], np.int32)
        out[arch] = generate(params, cfg, prompts, max_new=8)
        print(f"{arch}: prompts {prompts.tolist()} -> generated "
              f"{out[arch].tolist()}")
    return out


if __name__ == "__main__":
    main()
