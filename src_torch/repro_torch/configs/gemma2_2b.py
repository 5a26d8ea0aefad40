"""gemma2-2b — local/global alternating attention + logit softcaps
[arXiv:2408.00118].

long_500k note (DESIGN.md §5): the long-context variant switches global
layers to sliding-window so the whole stack is sub-quadratic — use
``long_context()``, a documented deviation from the published eval config.
"""
from .base import ModelConfig

FULL = ModelConfig(
    arch_id="gemma2-2b", family="dense",
    source="arXiv:2408.00118 (Gemma 2)",
    n_layers=26, d_model=2304, vocab_size=256000,
    n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, act="gelu", glu=True,
    attn_pattern=("local", "global"), sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    tie_embeddings=True, scale_embeddings=True,
)


def long_context() -> ModelConfig:
    """All-sliding-window variant for long_500k (sub-quadratic)."""
    return FULL.replace(attn_pattern=("local", "local"))


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=256, vocab_size=512,
                        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                        sliding_window=64, dtype="float32", remat=False)
