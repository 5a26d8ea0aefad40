"""State-space layers: Mamba-1 (falcon-mamba).

Port of the Mamba-1 half of ``repro.models.ssm``: the reference's leaves
and layouts (dense weights ``(d_in, d_out)``, the depthwise conv ``(K,
I)``, ``dt_bias``, ``A_log`` and ``D`` in float32), its initializers and
``mamba1_forward`` with its dtype promotions.

Every selective scan goes through one function,
:func:`repro_torch.kernels.ssm_scan.mamba_scan`, which takes in the
mixer's elementwise chain around the scan (the softplus of dt, ``A =
-exp(A_log)``, the D skip and the SiLU gate): the hand-written kernel
for tensors on the card, its plain version for tensors on the CPU.  The
reference picks one of four routes for the same recurrence
(the chunked XLA scan when ``cfg.ssm_chunk`` divides S, its Pallas
kernel under ``attn_impl="pallas"`` without a state, the associative
scan, and a ``lax.scan`` from a carried state); the port's kernel takes
the carried state, so the cache-free forward, a prefill from the
engine's zero state and each decode step all run it, and ``ssm_chunk``
and ``attn_impl`` do not change the forward result.

Training differentiates the reference's XLA routes: the kernel has no
backward, so a cache-free call under autograd hands the kernel
:func:`mamba_scan_twin`, the mixer's chain around the reference's
chunked scan (``_chunked_ssd1``, each chunk rematerialized, when
``cfg.ssm_chunk`` divides S) or its associative scan
(``_assoc_scan``), and backward returns its vector-Jacobian product,
recomputed.

State layout: ``h`` (B, I, N) float32, I = ``expand * d_model``, N =
``ssm_state``; the conv cache (B, K-1, I) in the model's dtype, the last
K-1 inputs of the causal conv.  Mamba-2 (zamba2) raises
:class:`NotImplementedError`.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._recompute import recompute_vjp
from ..configs.base import ModelConfig
from ..kernels.ssm_scan import ops as ssm_ops
from .common import dense_param, dtype_of, init_dense


MAMBA2_NOT_PORTED = "mamba-2 layers are not ported: ROADMAP Queue 1 item 11c"


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                conv_cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of x (B, S, C) with w (K, C), as the
    reference's K shifted adds (not ``F.conv1d``: cuDNN would run it in
    TF32 and sum in another order).  The window starts from
    ``conv_cache`` (B, K-1, C), or from zeros.  Returns (y, the last K-1
    inputs)."""
    K = w.shape[0]
    if conv_cache is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_cache, x], dim=1)
    new_cache = xp[:, xp.shape[1] - (K - 1):]
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return y + b, new_cache


# --- the reference's XLA scans, the kernel's differentiable twins -------------

def _assoc_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t along axis 1 from h_0 = 0, as a log-depth
    inclusive scan (the reference's ``lax.associative_scan`` with the
    same combine).  a, b (B, S, ...).  Returns (cumulative product of a,
    h)."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return a, b


def _ssd1_chunk(h0, x_i, dt_i, b_i, c_i, A):
    """One chunk of :func:`_chunked_ssd1` from the state h0: (its last
    state, y of the chunk)."""
    f32 = torch.float32
    a = torch.exp(dt_i[..., None] * A)
    bu = (dt_i * x_i.to(f32))[..., None] * b_i.to(f32)[..., None, :]
    cum_a, h_local = _assoc_scan(a, bu)
    h = h_local + cum_a * h0[:, None]
    return h[:, -1], torch.einsum("bsin,bsn->bsi", h, c_i.to(f32))


def _chunked_ssd1(xs, dt, B_ssm, C_ssm, A, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's fused chunked scan -> (y (B, S, I) f32, h_final
    (B, I, N)): the (B, chunk, I, N) state of one chunk at a time, each
    chunk rematerialized in backward (``jax.checkpoint(body)``)."""
    B, S, I = xs.shape
    h = torch.zeros((B, I, B_ssm.shape[-1]), dtype=torch.float32,
                    device=xs.device)
    ys = []
    for c in range(0, S, chunk):
        part = (h, xs[:, c:c + chunk], dt[:, c:c + chunk],
                B_ssm[:, c:c + chunk], C_ssm[:, c:c + chunk], A)
        h, y = recompute_vjp(_ssd1_chunk, _ssd1_chunk, part)
        ys.append(y)
    return torch.cat(ys, 1), h


def mamba_scan_twin(x, dt_lin, dt_bias, Bc, Cc, A_log, D, z, *,
                    chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``mamba1_forward`` from its projections to the
    gate, without a carried state, differentiable: dt = softplus(dt_lin +
    dt_bias) in float32, A = -exp(A_log), the chunked scan when ``chunk``
    divides S (and S > chunk), else the associative scan, then (y + D
    x).to(x.dtype) * silu(z).  Returns (out, h_final), as
    :func:`~repro_torch.kernels.ssm_scan.mamba_scan`."""
    f32 = torch.float32
    dt = F.softplus(dt_lin + dt_bias).to(f32)
    A = -torch.exp(A_log)
    S = x.shape[1]
    if chunk and S > chunk and S % chunk == 0:
        y, h = _chunked_ssd1(x, dt, Bc, Cc, A, chunk)
    else:
        a = torch.exp(dt[..., None] * A)
        bu = (dt * x.to(f32))[..., None] * Bc.to(f32)[..., None, :]
        _, hs = _assoc_scan(a, bu)
        h = hs[:, -1]
        y = torch.einsum("bsin,bsn->bsi", hs, Cc.to(f32))
    y = y + D * x.to(f32)
    return y.to(x.dtype) * F.silu(z), h


class Mamba1(nn.Module):
    """One Mamba-1 mixer: in_proj, causal conv, SiLU, x_proj to (dt, B,
    C), dt_proj with softplus, the selective scan, the D skip, the SiLU
    gate and out_proj."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        if cfg.mamba_version != 1:
            raise NotImplementedError(f"{cfg.arch_id}: {MAMBA2_NOT_PORTED}")
        D, I, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
        K, R = cfg.ssm_conv, dt_rank(cfg)
        dt, f32 = dtype_of(cfg), torch.float32
        self.rank, self.n_state, self.chunk = R, N, cfg.ssm_chunk
        self.in_proj = dense_param(D, 2 * I, dt, device)
        self.conv_w = _param((K, I), dt, device)
        self.conv_b = _param((I,), dt, device)
        self.x_proj = dense_param(I, R + 2 * N, dt, device)
        self.dt_proj = dense_param(R, I, dt, device)
        self.dt_bias = _param((I,), f32, device)
        self.A_log = _param((I, N), f32, device)
        self.D = _param((I,), f32, device)
        self.out_proj = dense_param(I, D, dt, device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """The reference's ``init_mamba``: dense weights truncated normal
        (``dt_proj`` at ``R ** -0.5``, ``out_proj`` at ``I ** -0.5``), the
        conv a normal at ``K ** -0.5``, zero conv bias, ``dt_bias`` the
        inverse softplus of dt drawn log-uniform in [1e-3, 1e-1],
        ``A_log = log(1..N)`` on every channel, ``D = 1``."""
        K, I = self.conv_w.shape
        N, R = self.n_state, self.rank
        dev, f32 = self.conv_w.device, torch.float32
        init_dense(self.in_proj, generator)
        w = torch.randn((K, I), generator=generator, dtype=f32, device=dev)
        self.conv_w.copy_(K ** -0.5 * w)
        self.conv_b.zero_()
        init_dense(self.x_proj, generator)
        init_dense(self.dt_proj, generator, std=R ** -0.5)
        u = torch.rand((I,), generator=generator, dtype=f32, device=dev)
        log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
        self.dt_bias.copy_(torch.log(torch.expm1(torch.exp(log_dt))))
        a = torch.arange(1, N + 1, dtype=f32, device=dev)
        self.A_log.copy_(torch.log(a).expand(I, N))
        self.D.fill_(1.0)
        init_dense(self.out_proj, generator, std=I ** -0.5)

    def forward(self, x: torch.Tensor, state: Optional[torch.Tensor] = None,
                conv_cache: Optional[torch.Tensor] = None, *,
                state_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, S, D) -> (y (B, S, D), new state (B, I, N) f32, new conv
        cache (B, K-1, I)); with ``state`` and ``conv_cache`` the scan and
        the conv continue from them (prefill into a cache, decode).  With
        ``state_out`` (B, I, N) f32 the new state is written into it and
        returned; it may be ``state`` (the serving cache, carried on in
        place)."""
        R, N = self.rank, self.n_state
        xs, z = (x @ self.in_proj).chunk(2, dim=-1)            # (B, S, I)
        xs, new_conv = causal_conv(xs, self.conv_w, self.conv_b, conv_cache)
        xs = F.silu(xs)
        xdb = xs @ self.x_proj                                  # (B, S, R+2N)
        dt_in, B_ssm, C_ssm = xdb.split([R, N, N], dim=-1)
        # the scan with the reference's chain around it: dt = softplus(
        # dt_in @ dt_proj + dt_bias) (model dtype + f32 bias promotes to
        # f32), A = -exp(A_log), then (y + D xs).to(x.dtype) * silu(z)
        twin = (functools.partial(mamba_scan_twin, chunk=self.chunk)
                if torch.is_grad_enabled() else None)
        y, new_state = ssm_ops.mamba_scan(xs, dt_in @ self.dt_proj,
                                          self.dt_bias, B_ssm, C_ssm,
                                          self.A_log, self.D, z, h0=state,
                                          h_out=state_out, twin=twin)
        return y @ self.out_proj, new_state, new_conv


def init_ssm_state(cfg: ModelConfig, batch: int,
                   device: torch.device) -> dict:
    """A Mamba-1 layer's decode cache: ``{"state": (B, I, N) f32,
    "conv": (B, K-1, I)}`` in the model's dtype, zeros."""
    I, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"state": torch.zeros((batch, I, N), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, K - 1, I), dtype=dtype_of(cfg),
                                device=device)}
