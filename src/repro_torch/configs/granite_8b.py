"""granite-8b [dense]: llama-arch (code model).

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152. [arXiv:2405.04324; hf]
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, vocab=49152,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, act="silu",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="granite-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, act="silu",
    )
