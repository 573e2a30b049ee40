"""gemma3-12b [hf:google/gemma-3-*-pt]: 5:1 local:global, 256k vocab."""
import dataclasses
from repro_torch.models.common import ArchConfig

_BASE = ArchConfig(
    name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, d_head=256, d_ff=15360, vocab=262144,
    act="gelu", local_window=1024, local_ratio=5, rope_theta=1000000.0,
    tie_embeddings=True)


def config():
    return _BASE


def smoke_config():
    return dataclasses.replace(
        _BASE, name="gemma3-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256, local_window=8,
        local_ratio=2)
