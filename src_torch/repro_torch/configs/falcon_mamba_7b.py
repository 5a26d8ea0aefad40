"""falcon-mamba-7b — attention-free Mamba-1 LM [arXiv:2410.05355]."""
from .base import ModelConfig

FULL = ModelConfig(
    arch_id="falcon-mamba-7b", family="ssm",
    source="arXiv:2410.05355 (Falcon Mamba: 7B attention-free)",
    n_layers=64, d_model=4096, vocab_size=65024,
    d_ff=0, n_heads=1, n_kv_heads=1, rope=False,
    ssm_state=16, ssm_conv=4, ssm_expand=2, mamba_version=1,
    ssm_chunk=1024,
    glu=False,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=256, vocab_size=512,
                        ssm_state=8, dtype="float32", remat=False)
