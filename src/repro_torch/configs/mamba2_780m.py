"""mamba2-780m [arXiv:2405.21060]: pure SSD stack, attention-free."""
import dataclasses
from repro_torch.models.common import ArchConfig

_BASE = ArchConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=1, n_kv_heads=1, d_head=64, d_ff=0, vocab=50280,
    act="silu", ssm_state=128, ssm_expand=2, ssm_conv=4, ssm_head_dim=64,
    tie_embeddings=True)


def config():
    return _BASE


def smoke_config():
    return dataclasses.replace(
        _BASE, name="mamba2-smoke", n_layers=2, d_model=64, vocab=256,
        ssm_state=16, ssm_head_dim=16)
