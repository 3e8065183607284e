"""falcon-mamba-7b [ssm]: pure Mamba1, attention-free.

64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16, d_inner=8192,
dt_rank=256, d_conv=4. [arXiv:2410.05355; unverified]
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, vocab=65024,
    ssm_variant="mamba1", ssm_state=16, d_inner=8192, dt_rank=256, d_conv=4,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-smoke", family="ssm",
        n_layers=2, d_model=64, vocab=256,
        ssm_variant="mamba1", ssm_state=8, d_inner=128, dt_rank=8, d_conv=4,
    )
