"""zamba2-2.7b [arXiv:2411.15242]: Mamba2 stack + weight-shared attn block."""
import dataclasses
from repro_torch.models.common import ArchConfig

_BASE = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_head=80, d_ff=10240, vocab=32000,
    act="silu", ssm_state=64, ssm_expand=2, ssm_conv=4, ssm_head_dim=64,
    hybrid_attn_every=6, tie_embeddings=True)


def config():
    return _BASE


def smoke_config():
    return dataclasses.replace(
        _BASE, name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=256, ssm_state=16,
        ssm_head_dim=16, hybrid_attn_every=2)
