"""llama3-405b [arXiv:2407.21783]: dense GQA, 128k vocab."""
import dataclasses
from repro_torch.models.common import ArchConfig

_BASE = ArchConfig(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, d_head=128, d_ff=53248, vocab=128256,
    act="silu", rope_theta=500000.0, tie_embeddings=False, policy="bf16_opt16")


def config():
    return _BASE


def smoke_config():
    return dataclasses.replace(
        _BASE, name="llama3-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=16, d_ff=192, vocab=256)
