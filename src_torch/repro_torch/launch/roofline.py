"""The model-level roofline on an NVIDIA H100, port of the plain parts of
``repro.launch.roofline``.

Three terms per workload, in seconds:

  compute    = FLOPs / peak FLOP/s
  memory     = HBM bytes / HBM rate
  collective = collective bytes / link rate

with the H100 SXM's data-sheet rates: 989e12 dense bf16 FLOP/s on the
tensor cores (``PEAK_FLOPS``), 67e12 f32 FLOP/s outside them
(``F32_FLOPS``), 3.35e12 B/s of HBM3 (``HBM_BW``), 450e9 B/s a direction
of NVLink (``NVLINK_BW``), and ``SFU_PER_S`` exponentials a second.
``RooflineTerms`` takes the FLOP rate its work runs at (bf16 by
default).  ``mtl_score_terms`` and ``prox_step_terms`` (the analytic
cost models of two kernels), ``model_flops`` (6·N·D for a train step)
and the parameter counts are the reference's, copied.

Left out, because they read what XLA compiled: ``parse_collectives``
and ``terms_from_compiled`` (the HLO text and ``cost_analysis()`` of a
lowered program; the port's collective bytes come from the runtime's
``collective_floats_per_chip`` and ``analysis/collectives.py``'s
records instead).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12          # dense bf16 on the tensor cores, H100 SXM
F32_FLOPS = 67e12            # f32 outside the tensor cores, H100 SXM
HBM_BW = 3.35e12             # bytes/s, HBM3, H100 SXM
NVLINK_BW = 450e9            # bytes/s a direction, NVLink 4
# exponentials: the SFU's 16 a clock on each of 132 SMs at the 1.98 GHz
# of the f32 peak (67 TFLOP/s = 132 x 128 x 2 x 1.98e9)
SFU_PER_S = 132 * 16 * 1.98e9


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    collectives: Dict[str, int]
    flops_per_s: float = PEAK_FLOPS

    @property
    def t_compute(self) -> float:
        return self.flops / self.flops_per_s

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_roofline(self) -> float:
        """The roofline lower bound: the slowest of the three terms
        (they overlap on real hardware, so max, not sum)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def achieved_fraction(self, measured_s: float) -> float:
        """Fraction of the roofline bound a measured time achieves (1.0 =
        running at the model's limit)."""
        if measured_s <= 0.0:
            return 0.0
        return self.t_roofline / measured_s

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_roofline_s": self.t_roofline, "dominant": self.dominant,
            "collectives": self.collectives,
        }


# ---------------------------------------------------------------------------
# analytic cost-model entries for the repo's fused MTL kernels
# ---------------------------------------------------------------------------
def mtl_score_terms(B: int, p: int, r: int, m: int, x_bytes: int = 4,
                    code_bytes: int = 4) -> RooflineTerms:
    """Cost model of :mod:`repro_torch.kernels.mtl_score` for one batch.

    One (B, p) x (p, r) gemm plus the gather/dequantize/reduce epilogue;
    HBM traffic is each operand exactly once — X, U, the (m, r) code
    table at its STORED width (``code_bytes``: 4 f32, 1 int8/fp8), the
    (m, 1) f32 scale column, ids, and the (B,) output.  No collectives:
    the kernel is single-device by design (DESIGN.md §14).  Its work is
    f32, so the compute term runs at ``F32_FLOPS``.
    """
    flops = 2.0 * B * p * r + 3.0 * B * r
    hbm = (B * p * x_bytes + p * r * 4 + m * r * code_bytes + m * 4
           + B * 4 + B * 4)
    return RooflineTerms(flops=flops, hbm_bytes=float(hbm),
                         collective_bytes=0.0, collectives={"count": 0},
                         flops_per_s=F32_FLOPS)


def prox_step_terms(L: int, n: int, p: int, x_bytes: int = 4
                    ) -> RooflineTerms:
    """Cost model of :mod:`repro_torch.kernels.prox_step` for one fused
    worker update over L local tasks with n rows each.

    Two (n, p) passes per task (predictions + residual
    accumulation) and an O(p) step epilogue; HBM traffic is X and y
    once plus the four (L, p) vectors (W, Z, Q in, W out).  The
    data-axis pmean happens OUTSIDE the kernel (that is the point —
    the CommLog is unchanged), so collective bytes are zero here.  Its
    work is f32, so the compute term runs at ``F32_FLOPS``.
    """
    flops = 4.0 * L * n * p + 8.0 * L * p
    hbm = L * n * p * x_bytes + L * n * 4 + 4 * L * p * 4 + 16
    return RooflineTerms(flops=flops, hbm_bytes=float(hbm),
                         collective_bytes=0.0, collectives={"count": 0},
                         flops_per_s=F32_FLOPS)


def model_flops(cfg, shape, n_tokens: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE), N = active params
    (counting backward 2x fwd). Decode steps process ONE token per
    sequence, so n_tokens = global_batch."""
    n_active = active_param_count(cfg)
    if n_tokens is None:
        n_tokens = (shape.global_batch if shape.kind == "decode"
                    else shape.seq_len * shape.global_batch)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * n_tokens


def total_param_count(cfg) -> float:
    """TOTAL parameter count (all experts), for memory-footprint checks."""
    if not getattr(cfg, "is_moe", False):
        return active_param_count(cfg)
    D = cfg.d_model
    dff = cfg.moe_d_ff or cfg.d_ff
    factor = 3 if cfg.glu else 2
    extra_experts = (cfg.n_experts - cfg.n_experts_per_token)
    per_layer_extra = factor * D * dff * extra_experts
    n_moe_layers = cfg.n_layers - cfg.first_k_dense
    return active_param_count(cfg) + n_moe_layers * per_layer_extra


def active_param_count(cfg) -> float:
    """Active (per-token) parameter count from config dims."""
    D = cfg.d_model
    V = cfg.vocab_size
    emb = V * D * (1 if cfg.tie_embeddings else 2)
    # attention
    if cfg.family not in ("ssm",):
        if cfg.mla:
            qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            q = (cfg.q_lora_rank * (D + cfg.n_heads * qk)
                 if cfg.q_lora_rank else D * cfg.n_heads * qk)
            kv = D * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) \
                + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_head_dim
                                                    + cfg.v_head_dim)
            o = cfg.n_heads * cfg.v_head_dim * D
            attn = q + kv + o
        else:
            hd = cfg.resolved_head_dim
            attn = D * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    else:
        attn = 0.0
    # mlp / moe active
    if cfg.is_moe:
        dff = cfg.moe_d_ff or cfg.d_ff
        factor = 3 if cfg.glu else 2
        active_e = cfg.n_experts_per_token + cfg.n_shared_experts
        moe = factor * D * dff * active_e + D * cfg.n_experts
        dense_mlp = factor * D * cfg.d_ff
        k_dense = cfg.first_k_dense
        per_layer_moe = attn + moe
        per_layer_dense = attn + dense_mlp
        layers = (cfg.n_layers - k_dense) * per_layer_moe \
            + k_dense * per_layer_dense
        return emb + layers
    if cfg.is_ssm:
        I, N = cfg.d_inner, cfg.ssm_state
        if cfg.mamba_version == 2:
            H = I // cfg.mamba_headdim
            m1 = D * (2 * I + 2 * N + H) + I * D
        else:
            R = max(1, -(-D // 16))
            m1 = D * 2 * I + I * (R + 2 * N) + R * I + I * D
        shared = 0.0
        if cfg.family == "hybrid":       # one shared block, counted once
            hd = cfg.resolved_head_dim
            shared = D * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2) \
                + (3 if cfg.glu else 2) * D * cfg.d_ff
        return emb + cfg.n_layers * m1 + shared
    factor = 3 if cfg.glu else 2
    per_layer = attn + factor * D * cfg.d_ff
    layers = cfg.n_layers * per_layer
    if cfg.family == "encdec":
        hd = cfg.resolved_head_dim
        xattn = D * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        layers += cfg.n_layers * xattn
        layers += cfg.n_enc_layers * per_layer
    return emb + layers
