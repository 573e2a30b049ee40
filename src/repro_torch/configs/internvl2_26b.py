"""internvl2-26b [arXiv:2404.16821]: InternViT (stub) + InternLM2-20B."""
import dataclasses
from repro_torch.models.common import ArchConfig

_BASE = ArchConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_head=128, d_ff=16384, vocab=92553,
    act="silu", rope_theta=1000000.0, vis_tokens=1024,
    tie_embeddings=False, policy="bf16_opt16")


def config():
    return _BASE


def smoke_config():
    return dataclasses.replace(
        _BASE, name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256, vis_tokens=8)
