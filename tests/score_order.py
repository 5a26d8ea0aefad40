"""A plain emulation of the summation order of the port's scoring kernel
(``src_torch/repro_torch/kernels/mtl_score/csrc/mtl_score.cu``), for the
CPU tests, which cannot run the kernel.

A launch (``kernel.plan``) cuts a row's p over ``warps_per_row`` warps;
lane g of the row (g = w * 32 + lane) adds x_j U[j, k] into its r sums
with fused multiply-adds, for the elements j that
``kernel.lane_elements`` gives it, in that order.  A warp's lanes are
added pairwise at distances 16, 8, 4, 2, 1, then the warps of a row in
warp order.  Lane k < r then multiplies projection k by code element k
of the clamped row times its scale (one f32 product, formed first), and
lanes 0..7 are added pairwise at distances 4, 2, 1.

A fused multiply-add is emulated in float64: the product of two f32
values is exact there, and the sum is rounded to f64, then to f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mtl_score import kernel

LANES = 32


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def lane_index(p: int, x_bytes: int, pl: kernel.Plan, aligned: bool
               ) -> torch.Tensor:
    """(lanes, steps) int64: the element each lane of a row reads at each
    step of its chain, -1 past its last."""
    elems = kernel.lane_elements(p, x_bytes, pl, aligned)
    steps = max(1, max(map(len, elems)))
    out = torch.full((len(elems), steps), -1, dtype=torch.int64)
    for g, js in enumerate(elems):
        out[g, :len(js)] = torch.tensor(js, dtype=torch.int64)
    return out


def projections(U, X, pl, aligned):
    """(B, r) f32: x_b . U in the kernel's order, every row read as
    ``aligned`` says."""
    B, p = X.shape
    r = U.shape[1]
    idx = lane_index(p, X.element_size(), pl, aligned)
    xf, uf = X.float(), U.float()
    acc = torch.zeros(B, idx.shape[0], r)
    for t in range(idx.shape[1]):
        j = idx[:, t]
        live = (j >= 0)[None, :, None]
        jj = j.clamp_min(0)
        acc = torch.where(live, fma(xf[:, jj, None], uf[jj][None], acc), acc)
    warps = acc.view(B, -1, LANES, r)
    off = 16
    while off:
        warps = warps + warps[:, :, torch.arange(LANES) ^ off]
        off //= 2
    warps = warps[:, :, 0]                        # (B, warps of a row, r)
    z = warps[:, 0]
    for w in range(1, pl.warps_per_row):
        z = z + warps[:, w]
    return z


def score(U, C, S, ids, X, n_sm=132, pl=None):
    """U (p, r), C (m, r), S (m, 1), ids (B,), X (B, p) -> (B,) f32, in
    the kernel's order at ``pl`` (default: the plan for a card of
    ``n_sm`` SMs), X itself 16-byte aligned (so its rows are when p *
    x_bytes is a multiple of 16)."""
    B, p = X.shape
    m, r = C.shape
    pl = pl or kernel.plan(B, n_sm)
    z = projections(U, X, pl, (p * X.element_size()) % 16 == 0)
    idx = ids.long().clamp(0, m - 1)
    rows = C.view(torch.uint8).index_select(0, idx).view(C.dtype) \
        if C.element_size() == 1 else C.index_select(0, idx)
    code = rows.float() * S.float()[idx]          # (B, r), one rounding
    lanes = torch.zeros(B, 8)
    lanes[:, :r] = z * code
    off = 4
    while off:
        lanes = lanes + lanes[:, torch.arange(8) ^ off]
        off //= 2
    return lanes[:, 0]
