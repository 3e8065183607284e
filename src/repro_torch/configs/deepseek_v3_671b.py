"""deepseek-v3-671b [moe]: MLA + 1 shared + 256 routed experts top-8, MTP.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280. MLA: q_lora=1536,
kv_lora=512, rope_head_dim=64, qk_nope/v head_dim=128. [arXiv:2412.19437; hf]

Deviation (DESIGN.md §7): the real model's first 3 layers are dense FFN; we
model all 61 as MoE (homogeneous layer scan), which changes <0.5% of params.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, vocab=129280,
    n_heads=128, n_kv_heads=128, head_dim=128,
    n_experts=256, top_k=8, d_expert_ff=2048, n_shared_experts=1,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
    act="silu", mtp_depth=1,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-smoke", family="moe",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=16,
        n_experts=8, top_k=2, d_expert_ff=32, n_shared_experts=1,
        use_mla=True, q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
        act="silu", mtp_depth=1,
    )
