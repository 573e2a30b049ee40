"""qwen2-0.5b [arXiv:2407.10671]: dense GQA with QKV bias."""
import dataclasses
from repro_torch.models.common import ArchConfig

_BASE = ArchConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_head=64, d_ff=4864, vocab=151936,
    act="silu", qkv_bias=True, rope_theta=1000000.0, tie_embeddings=True)


def config():
    return _BASE


def smoke_config():
    return dataclasses.replace(
        _BASE, name="qwen2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256)
