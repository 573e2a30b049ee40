"""moonshot-v1-16b-a3b (Moonlight) [hf:moonshotai/Moonlight-16B-A3B]."""
import dataclasses
from repro_torch.models.common import ArchConfig

_BASE = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_head=128, d_ff=1408, vocab=163840,
    act="silu", n_experts=64, top_k=6, rope_theta=50000.0,
    tie_embeddings=True)


def config():
    return _BASE


def smoke_config():
    return dataclasses.replace(
        _BASE, name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=96, vocab=256, n_experts=8, top_k=2)
