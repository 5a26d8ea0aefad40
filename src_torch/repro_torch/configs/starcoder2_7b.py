"""starcoder2-7b — dense GQA + RoPE code LM [arXiv:2402.19173]."""
from .base import ModelConfig

FULL = ModelConfig(
    arch_id="starcoder2-7b", family="dense",
    source="arXiv:2402.19173 (StarCoder2)",
    n_layers=32, d_model=4608, vocab_size=49152,
    n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, act="gelu", glu=False, norm="layernorm",
    rope=True, rope_theta=1e5,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=256, vocab_size=512,
                        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                        dtype="float32", remat=False)
