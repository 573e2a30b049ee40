"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
import dataclasses
from repro_torch.models.common import ArchConfig

_BASE = ArchConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, d_head=64, d_ff=512, vocab=49155,
    act="silu", n_experts=32, top_k=8, tie_embeddings=True)


def config():
    return _BASE


def smoke_config():
    return dataclasses.replace(
        _BASE, name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=64, vocab=256, n_experts=4, top_k=2)
