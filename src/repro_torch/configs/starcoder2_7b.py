"""starcoder2-7b [arXiv:2402.19173]: dense GQA with bias, GELU."""
import dataclasses
from repro_torch.models.common import ArchConfig

_BASE = ArchConfig(
    name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
    n_heads=36, n_kv_heads=4, d_head=128, d_ff=18432, vocab=49152,
    act="gelu", qkv_bias=True, rope_theta=100000.0, tie_embeddings=True)


def config():
    return _BASE


def smoke_config():
    return dataclasses.replace(
        _BASE, name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256)
