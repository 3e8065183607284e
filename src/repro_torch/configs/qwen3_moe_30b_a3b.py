"""qwen3-moe-30b-a3b [moe]: 128 experts top-8.

48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768 vocab=151936, head_dim=128.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, vocab=151936,
    n_heads=32, n_kv_heads=4, head_dim=128,
    n_experts=128, top_k=8, d_expert_ff=768, n_shared_experts=0,
    act="silu", rope_theta=1_000_000.0,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16,
        n_experts=8, top_k=2, d_expert_ff=32, n_shared_experts=0,
        act="silu",
    )
