"""whisper-base [audio]: encoder-decoder; conv frontend is a STUB
(input_specs provides precomputed frame embeddings).

6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865. [arXiv:2212.04356]
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=12, n_enc_layers=6, n_dec_layers=6,
    d_model=512, vocab=51865,
    n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, act="gelu",
    frontend_stub="audio_frames",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-smoke", family="audio",
        n_layers=4, n_enc_layers=2, n_dec_layers=2,
        d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, act="gelu",
        frontend_stub="audio_frames",
    )
