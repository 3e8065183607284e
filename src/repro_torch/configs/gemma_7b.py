"""gemma-7b [dense]: GeGLU, head_dim=256.

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000. [arXiv:2403.08295; hf]
(d_ff=24576 is the published 2x gated hidden total; per-branch 8192x... we
use the config value directly as the gated hidden width.)
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, vocab=256000,
    n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, act="geglu", tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="gemma-smoke", family="dense",
        n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, act="geglu", tie_embeddings=True,
    )
