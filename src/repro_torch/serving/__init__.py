"""Posit-quantized LLM serving (counterpart of ``repro.serving``): weight
quantization, the paged posit KV-cache, continuous batching, synthetic
traffic replay."""
from repro_torch.serving.engine import (Engine, Request, generate, prefill,
                                        prefill_loop)
from repro_torch.serving.kv_cache import PagedKVSpec, PagePool
from repro_torch.serving.quantize import (QuantConfig, dequantize_params,
                                          param_bytes, quantize_params,
                                          weight_golden_zone)
from repro_torch.serving.traffic import TrafficConfig, replay, synth_trace

__all__ = [
    "Engine", "Request", "generate", "prefill", "prefill_loop",
    "PagedKVSpec", "PagePool", "QuantConfig", "dequantize_params",
    "param_bytes", "quantize_params", "weight_golden_zone",
    "TrafficConfig", "replay", "synth_trace",
]
