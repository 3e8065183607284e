"""tinyllama-1.1b [dense]: llama2-arch small.

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000. [arXiv:2401.02385; hf]
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, vocab=32000,
    n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, act="silu",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=176, act="silu",
    )
