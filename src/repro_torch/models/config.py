"""Architecture configuration schema for the assigned model zoo."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                 # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    # mlp
    d_ff: int = 0
    act: str = "silu"                 # silu | gelu | geglu (gated variants)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    # SSM
    ssm_state: int = 0
    ssm_variant: str = ""             # mamba1 | mamba2
    d_inner: int = 0
    d_conv: int = 4
    ssm_head_dim: int = 64
    dt_rank: int = 0
    # hybrid (zamba2): shared attention block applied every k SSM blocks
    attn_every: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # multi-token prediction (deepseek-v3)
    mtp_depth: int = 0
    # modality frontend stub dims ([audio]/[vlm]): embeddings precomputed
    frontend_stub: str = ""           # "" | audio_frames | image_patches
    # norm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """sub-quadratic decode: SSM / hybrid archs only (DESIGN.md §4)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d = self.d_model
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            per = (self.n_heads + 2 * self.n_kv_heads) * self.hd * d + self.n_heads * self.hd * d
            per += 3 * d * self.d_ff
            n += self.n_layers * per
        elif self.family == "moe":
            if self.use_mla:
                attn = (
                    d * self.q_lora_rank
                    + self.q_lora_rank * self.n_heads * (self.hd + self.rope_head_dim)
                    + d * (self.kv_lora_rank + self.rope_head_dim)
                    + self.kv_lora_rank * self.n_heads * 2 * self.hd
                    + self.n_heads * self.hd * d
                )
            else:
                attn = (self.n_heads + 2 * self.n_kv_heads) * self.hd * d + self.n_heads * self.hd * d
            moe = (self.n_experts + self.n_shared_experts) * 3 * d * self.d_expert_ff + d * self.n_experts
            n += self.n_layers * (attn + moe)
        elif self.family == "ssm":
            di = self.d_inner or 2 * d
            per = d * 2 * di + di * self.d_conv + di * (self.dt_rank or d // 16) * 2
            per += di * 2 * self.ssm_state + di * d
            n += self.n_layers * per
        elif self.family == "hybrid":
            di = self.d_inner or 2 * d
            nh = di // self.ssm_head_dim
            per = d * 2 * di + di * self.d_conv + di + 2 * nh * self.ssm_state * di // nh * nh // nh
            per += d * 2 * di + di * d  # rough proj terms
            n += self.n_layers * per
            attn = 4 * d * self.n_heads * self.hd + 3 * d * self.d_ff
            n += attn  # shared block counted once
        elif self.family == "audio":
            per = 4 * d * d + 2 * d * self.d_ff
            n += (self.n_enc_layers + 2 * self.n_dec_layers) * per
        return int(n)

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.use_mla:
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (self.hd + self.rope_head_dim)
                + d * (self.kv_lora_rank + self.rope_head_dim)
                + self.kv_lora_rank * self.n_heads * 2 * self.hd
                + self.n_heads * self.hd * d
            )
        else:
            attn = (self.n_heads + 2 * self.n_kv_heads) * self.hd * d + self.n_heads * self.hd * d
        act = (self.top_k + self.n_shared_experts) * 3 * d * self.d_expert_ff + d * self.n_experts
        return int(n + self.n_layers * (attn + act))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
