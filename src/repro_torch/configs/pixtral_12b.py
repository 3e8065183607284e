"""pixtral-12b [vlm]: Pixtral-ViT frontend (stub) + Mistral-Nemo backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
[hf:mistralai/Pixtral-12B-2409; unverified]
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, vocab=131072,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, act="silu", rope_theta=1_000_000.0,
    frontend_stub="image_patches",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="pixtral-smoke", family="vlm",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, act="silu", frontend_stub="image_patches",
    )
