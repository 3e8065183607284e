"""smollm-360m [dense]: llama-arch small.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
[hf:HuggingFaceTB/SmolLM-360M; hf]
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, vocab=49152,
    n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, act="silu", tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="smollm-smoke", family="dense",
        n_layers=2, d_model=60, vocab=256,
        n_heads=3, n_kv_heads=1, head_dim=20,
        d_ff=160, act="silu", tie_embeddings=True,
    )
