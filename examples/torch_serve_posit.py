"""Posit-quantized serving on the PyTorch/CUDA port: quantize a model's
weights to posit words, stand up the continuous-batching engine with a
paged p16e1 KV-cache, and replay a synthetic traffic trace — then show
the two claims that make it interesting: the batched decode is
bit-identical to serving each request alone, and the posit storage is
>= 2x smaller.  The port of ``examples/serve_posit.py``; on the GPU every
K/V write is encoded to p16e1 words by the port's encode kernel.

    PYTHONPATH=src python examples/torch_serve_posit.py [--device cpu]

The weights are the port's own, made from a seed (so the tokens differ
from the JAX example's).  Runs on the GPU unless ``--device cpu`` is
given, and raises when torch sees no GPU.
"""
import argparse

import numpy as np

from repro_torch import _device
from repro_torch.configs import get_tiny_config
from repro_torch.models import init_params
from repro_torch.serving import (Engine, QuantConfig, TrafficConfig,
                                 param_bytes, quantize_params, replay,
                                 synth_trace, weight_golden_zone)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    cfg = get_tiny_config("qwen2-0.5b", policy="f32")
    params = init_params(0, cfg, device=dev)

    # --- 1. quantize the weights to p16e1 --------------------------------
    # Per-channel pow2 equilibration first (exactly invertible in f32),
    # then round each weight to the nearest posit — the scales push the
    # channel maxima into the golden zone where p16e1 keeps its finest
    # spacing.
    qp = quantize_params(params, QuantConfig(fmt="p16e1"))
    pb = param_bytes(qp)
    out = dict(weight_ratio=pb["q_f32_bytes"] / pb["word_bytes"],
               weight_golden_zone=weight_golden_zone(qp))
    print(f"weights: {pb['q_f32_bytes']:,} f32 bytes -> "
          f"{pb['word_bytes']:,} posit bytes "
          f"({out['weight_ratio']:.1f}x smaller), "
          f"golden-zone occupancy {out['weight_golden_zone']:.2f}")

    # --- 2. serve a synthetic trace --------------------------------------
    # Continuous batching: requests arrive over time, are admitted into
    # free rows as pages permit, decode together in one fixed-width step,
    # and retire independently (eos / max_new).  The KV-cache lives in
    # paged p16e1 pools — same 2x saving as the weights.
    trace = synth_trace(TrafficConfig(n_requests=6, mean_plen=8, mean_new=5,
                                      vocab=cfg.vocab, seed=0))
    eng = Engine(qp, cfg, max_batch=3, page_size=16, max_seq=64,
                 kv_fmt="p16e1")
    rep = replay(eng, trace)
    kb = eng.kv_bytes()
    out.update(replay=rep, kv_ratio=kb["f32_bytes"] / kb["bytes"])
    print(f"replayed {rep['requests']} requests / {rep['tokens']} tokens in "
          f"{rep['steps']} steps: {rep['tok_s']:.0f} tok/s, "
          f"mean occupancy {rep['occupancy']:.2f}")
    print(f"KV pool: {kb['f32_bytes']:,} f32-equiv bytes -> {kb['bytes']:,} "
          f"stored ({out['kv_ratio']:.1f}x smaller)")

    # --- 3. batched == sequential, bit for bit ---------------------------
    # The engine decodes every inflight request in one step at a fixed
    # batch width; rows cannot see each other.  So the same requests
    # served one at a time (max_inflight=1) produce the same tokens.
    reqs = [type(r)(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
            for r in trace]
    seq = Engine(qp, cfg, max_batch=3, page_size=16, max_seq=64,
                 kv_fmt="p16e1", max_inflight=1).run(reqs)
    out["sequential"] = seq
    assert all(np.array_equal(rep["outputs"][k], seq[k]) for k in seq)
    print("batched decode is bit-identical to sequential decode")
    for rid in sorted(rep["outputs"]):
        print(f"  request {rid}: {rep['outputs'][rid].tolist()}")
    return out


if __name__ == "__main__":
    main()
