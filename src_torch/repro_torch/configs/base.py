"""Architecture configuration schema, the port's own copy.

``ModelConfig`` and ``InputShape`` are copied whole from the reference's
``repro.configs.base`` (which imports no JAX), so that the port never
imports the reference: the same fields, defaults and properties, and a
config built in one package reads the same in the other.  Fields that
only the reference's JAX programs read (``scan_layers``, the MoE routing
options) are kept so the schema stays one.  Serving ignores ``remat``
and ``bf16_grad_boundary``; training reads them (per-layer
rematerialization, the gradient cast).  ``ssm_chunk``, ``attn_impl``
and ``attn_chunk`` choose no forward route in the port, which runs every
attention and selective scan through its kernel; in training they pick
the reference route whose twin the kernel's backward differentiates
(:func:`repro_torch.models.attention.sdpa_twin`,
:func:`repro_torch.models.ssm.mamba_scan_twin`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------------
    arch_id: str = "unnamed"
    family: str = "dense"        # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""             # citation (paper / model card)

    # trunk ------------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    vocab_size: int = 1024
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # gemma-style sqrt(d_model) embedding scaling
    scale_embeddings: bool = False

    # attention ----------------------------------------------------------------
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None      # default d_model // n_heads
    rope: bool = True
    rope_theta: float = 10_000.0
    learned_pos_embed: bool = False     # whisper decoder
    attn_logit_softcap: Optional[float] = None   # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    sliding_window: Optional[int] = None
    # per-layer attention pattern, cycled over layers: entries
    # "global" | "local"; None -> all global. gemma2: ("local", "global")
    attn_pattern: Optional[Tuple[str, ...]] = None
    qk_norm: bool = False

    # MLA (deepseek-v3) --------------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 0                # 0 -> no q compression
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # mlp ----------------------------------------------------------------------
    d_ff: int = 1024
    act: str = "silu"             # silu | gelu
    glu: bool = True              # gated linear unit (SwiGLU / GeGLU)

    # MoE ------------------------------------------------------------------
    n_experts: int = 0            # 0 -> dense mlp
    n_experts_per_token: int = 2
    n_shared_experts: int = 0     # deepseek: 1 always-active shared expert
    moe_d_ff: Optional[int] = None  # expert hidden dim (default d_ff)
    first_k_dense: int = 0        # deepseek: first 3 layers use dense mlp
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # multi-token prediction (deepseek MTP) — one extra predict-ahead head
    mtp: bool = False

    # SSM (mamba) ------------------------------------------------------------
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1        # 1 (falcon-mamba) | 2 (zamba2 SSD)
    mamba_headdim: int = 64       # mamba2 head dim P
    # chunk the train/prefill selective scan (lax.scan over chunks,
    # associative scan within): peak state tensor is (B,chunk,I,N)
    # instead of (B,S,I,N) — §Perf H1-iter2. 0 disables.
    ssm_chunk: int = 0

    # hybrid (zamba2) ----------------------------------------------------------
    # apply a SHARED full-attention+mlp block after every `attn_period`
    # ssm layers (params reused each application)
    attn_period: int = 0          # 0 -> no interleaved shared attention

    # encoder-decoder (whisper) --------------------------------------------
    n_enc_layers: int = 0         # 0 -> decoder-only
    n_frames: int = 1500          # stubbed audio frame embeddings
    max_target_positions: int = 448

    # vlm (paligemma) ---------------------------------------------------------
    n_patches: int = 0            # stubbed image patch embeddings
    prefix_lm: bool = False       # bidirectional attention over the prefix

    # numerics / runtime --------------------------------------------------
    dtype: str = "bfloat16"       # activation/param dtype for lowering
    remat: bool = True            # activation checkpointing over blocks
    attn_impl: str = "auto"       # auto | naive | chunked | pallas
    # cast the residual-stream COTANGENT to the activation dtype at each
    # layer boundary (§Perf H2): jax's f32-internal norm/attention math
    # otherwise leaks f32 activation-gradients into the TP partial-sum
    # all-reduces — 2x the collective bytes of the bf16 forward.
    bf16_grad_boundary: bool = False
    moe_impl: str = "dispatch"    # dispatch (GShard einsum) | sorted | dense
    moe_group: int = 2048         # routing-group tokens for the sorted path
                                  # (0 -> one group per batch row); groups
                                  # aligned with seq shards keep the sort,
                                  # scatter and capacity bookkeeping local
    attn_chunk: int = 1024        # kv-chunk for chunked attention
    scan_layers: bool = True      # scan over stacked layer params

    # -----------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """Can this config serve a 500k-token context? (§DESIGN long_500k)"""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True   # SSM trunk + windowed shared attention
        # dense archs qualify only with sliding-window on ALL layers
        return (self.sliding_window is not None
                and (self.attn_pattern is None
                     or all(p == "local" for p in self.attn_pattern)))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, \
            f"{self.arch_id}: n_heads {self.n_heads} % kv {self.n_kv_heads}"
        if self.is_moe:
            assert self.n_experts_per_token <= self.n_experts
        if self.family == "encdec":
            assert self.n_enc_layers > 0
        if self.attn_pattern:
            assert self.sliding_window, "local layers need a window size"


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
