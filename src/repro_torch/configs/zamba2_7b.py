"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
The shared attention+MLP block (one set of weights) is applied every 6
Mamba2 blocks (Zamba2's shared-block design). [arXiv:2411.15242; unverified]
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, vocab=32000,
    n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, act="gelu",
    ssm_variant="mamba2", ssm_state=64, d_inner=7168, ssm_head_dim=64,
    d_conv=4, attn_every=6,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, act="gelu",
        ssm_variant="mamba2", ssm_state=16, d_inner=128, ssm_head_dim=32,
        d_conv=4, attn_every=2,
    )
