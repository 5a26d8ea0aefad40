"""gemma-7b — dense, GeGLU, head_dim=256 [arXiv:2403.08295]."""
from .base import ModelConfig

FULL = ModelConfig(
    arch_id="gemma-7b", family="dense",
    source="arXiv:2403.08295 (Gemma)",
    n_layers=28, d_model=3072, vocab_size=256000,
    n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, act="gelu", glu=True,            # GeGLU
    tie_embeddings=True, scale_embeddings=True,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=256, vocab_size=512,
                        n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512,
                        dtype="float32", remat=False)
