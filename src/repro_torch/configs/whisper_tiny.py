"""whisper-tiny [arXiv:2212.04356]: enc-dec, conv frontend stubbed."""
import dataclasses
from repro_torch.models.common import ArchConfig

_BASE = ArchConfig(
    name="whisper-tiny", family="encdec", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_head=64, d_ff=1536, vocab=51865,
    act="gelu", qkv_bias=True, enc_layers=4, enc_seq=1500,
    tie_embeddings=True, norm_eps=1e-5)


def config():
    return _BASE


def smoke_config():
    return dataclasses.replace(
        _BASE, name="whisper-tiny-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=128, enc_layers=2,
        enc_seq=16)
