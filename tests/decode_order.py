"""A plain emulation of the arithmetic order of the port's decode attention
kernel (``src_torch/repro_torch/kernels/flash_attention/csrc/flash_decode.cu``),
for the CPU tests, which cannot run the kernel.

A launch (``kernel.plan``, route ``"decode"``) gives one CTA to each
(batch row, KV head, split); split z takes key tiles [z T, z T + T) of
TK keys.  In a tile, warp w takes keys w KPW .. w KPW + KPW - 1, NS steps
of KPS keys, one key a group of LPK lanes; every warp holds all the
call's rows (R of them, rows past Sq * group being empty).  Lane li of a
group holds the 16-byte chunks c LPK + li (c < NCH) of the head dim: its
part of a score is a chain of fused multiply-adds over its EPL elements,
and the group's lanes are added pairwise at distances LPK/2, ..., 1.

Each warp keeps its own online softmax.  Per chunk of CS steps it takes
the max of the logits over the chunk's keys of all its groups; where
that max exceeds m (m = -inf at first), l and acc are scaled by
exp(m - max) (0 when m = -inf) and m takes it; then each group adds
p = exp(s - m) (0 for a key that does not count) to its own l and p v to
its own acc, step by step.  After the last tile the groups' l and acc
are added pairwise at group distances 1, 2, ...; the warps are merged in
warp order (weights exp(m_w - M), 0 for m_w = -inf) and, with several
splits, the splits in split order the same way; a row whose weights sum
to 0 comes out as 0.

A fused multiply-add is emulated in float64: the product of two f32
values is exact there, and the sum is rounded to f64, then to f32 (a
double rounding that can differ from the card's single one in the last
bit, far inside the tests' tolerances).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import kernel

NEG_INF = float("-inf")


class Geometry(NamedTuple):
    rows: int       # R: the instantiation's rows
    epl: int        # elements of a key's head dim a lane holds
    vec: int        # elements in 16 bytes
    lpk: int        # lanes a key
    kps: int        # keys a warp step
    tk: int         # keys a tile
    kpw: int        # keys a warp a tile
    ns: int         # steps a warp a tile
    cs: int         # steps a softmax chunk


def geometry(rows: int, hd: int, dtype: torch.dtype) -> Geometry:
    """The source's ``Cfg`` for an instantiation."""
    epl = 16 if rows <= 2 else 8
    vec = 16 // (torch.finfo(dtype).bits // 8)
    lpk = hd // epl
    kps = 32 // lpk
    tk = kernel.decode_tile_keys(hd, dtype)
    kpw = tk // kernel.DECODE_WARPS
    ns = kpw // kps
    cs = ns if ns * rows <= 16 else 16 // rows
    return Geometry(rows, epl, vec, lpk, kps, tk, kpw, ns, cs)


def key_partition(pl: kernel.Plan, geo: Geometry) -> torch.Tensor:
    """(n_split, tiles_per_split, warps, NS, KPS) int64: the key each
    (split, tile of the split, warp, step, group) takes; keys at or past
    Sk are the zero-filled slots past the cache."""
    z = torch.arange(pl.n_split)[:, None, None, None, None]
    t = torch.arange(pl.tiles_per_split)[None, :, None, None, None]
    w = torch.arange(kernel.DECODE_WARPS)[None, None, :, None, None]
    step = torch.arange(geo.ns)[None, None, None, :, None]
    grp = torch.arange(geo.kps)[None, None, None, None, :]
    return ((z * pl.tiles_per_split + t) * geo.tk + w * geo.kpw
            + step * geo.kps + grp)


def lane_dims(geo: Geometry, hd: int) -> torch.Tensor:
    """(LPK, EPL) int64: the head-dim elements lane li of a group holds,
    in the order of its chain."""
    li = torch.arange(geo.lpk)[:, None, None]
    c = torch.arange(geo.epl // geo.vec)[None, :, None]
    e = torch.arange(geo.vec)[None, None, :]
    return ((c * geo.lpk + li) * geo.vec + e).reshape(geo.lpk, geo.epl)


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def decode(q, k, v, q_pos, k_pos, *, causal=True, window=None, softcap=None,
           scale=None, n_sm=132):
    """q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), positions (B, Sq) and
    (B, Sk), Sq * H / Hkv at most 8: the decode kernel's output in q's
    dtype, in the kernel's order, for a card of ``n_sm`` SMs."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = hd ** -0.5 if scale is None else scale
    pl = kernel.plan(B, Sq, Sk, H, Hkv, hd, q.dtype, n_sm)
    assert pl.route == "decode"
    geo = geometry(pl.rows, hd, q.dtype)
    R, W, KPS, LPK = geo.rows, kernel.DECODE_WARPS, geo.kps, geo.lpk
    n_rows = Sq * group

    # rows of (b, kvh): row r is query r // group of head kvh*group + r % group
    qg = q.float().reshape(B, Sq, Hkv, group, hd).permute(0, 2, 1, 3, 4)
    qr = torch.zeros(B, Hkv, R, hd)
    qr[:, :, :n_rows] = qg.reshape(B, Hkv, n_rows, hd)
    qp = torch.zeros(B, R, dtype=torch.int64)
    qp[:, :n_rows] = q_pos.long().repeat_interleave(group, 1)
    row_ok = torch.arange(R) < n_rows

    # the keys in the launch's order, zero-filled past Sk (position -1)
    keys = key_partition(pl, geo)                 # (Z, T, W, NS, KPS)
    n_keys = keys.numel()
    kp = torch.full((B, n_keys), -1, dtype=torch.int64)
    kp[:, :Sk] = k_pos.long()
    kf = torch.zeros(B, n_keys, Hkv, hd)
    vf = torch.zeros(B, n_keys, Hkv, hd)
    kf[:, :Sk], vf[:, :Sk] = k.float(), v.float()
    kf = kf.permute(0, 2, 1, 3)                   # (B, Hkv, keys, hd)
    vf = vf.permute(0, 2, 1, 3)
    dims = lane_dims(geo, hd)                     # (LPK, EPL)

    Z, T = pl.n_split, pl.tiles_per_split
    m = torch.full((B, Hkv, Z, W, R), NEG_INF)
    l = torch.zeros(B, Hkv, Z, W, KPS, R)
    acc = torch.zeros(B, Hkv, Z, W, KPS, R, hd)
    for t in range(T):
        for c0 in range(0, geo.ns, geo.cs):
            idx = keys[:, t, :, c0:c0 + geo.cs, :]          # (Z, W, CS, KPS)
            kt = kf[:, :, idx]                   # (B, Hkv, Z, W, CS, KPS, hd)
            # each lane's chain over its elements, then the group's tree
            part = torch.zeros(kt.shape[:-1] + (R, LPK))
            for e in range(geo.epl):
                d = dims[:, e]
                part = fma(qr[:, :, None, None, None, None][..., d],
                           kt[..., None, d], part)
            off = LPK // 2
            while off:
                part = part + part[..., torch.arange(LPK) ^ off]
                off //= 2
            s = part[..., 0] * scale             # (B, Hkv, Z, W, CS, KPS, R)
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            kpos = kp[:, idx][:, None, ..., None]            # (B,1,Z,W,CS,KPS,1)
            qq = qp[:, None, None, None, None, None, :]
            ok = (kpos >= 0) & row_ok
            if causal:
                ok = ok & (kpos <= qq)
            if window is not None:
                ok = ok & (kpos > qq - window)
            s = torch.where(ok, s, NEG_INF)
            mx = s.amax(dim=(4, 5))                          # (B, Hkv, Z, W, R)
            up = mx > m
            alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - mx))
            l = torch.where(up[:, :, :, :, None], l * alpha[:, :, :, :, None], l)
            acc = torch.where(up[:, :, :, :, None, :, None],
                              acc * alpha[:, :, :, :, None, :, None], acc)
            m = torch.where(up, mx, m)
            p = torch.where(s == NEG_INF, 0.0,
                            torch.exp(s - m[:, :, :, :, None, None]))
            vt = vf[:, :, idx]                   # (B, Hkv, Z, W, CS, KPS, hd)
            for cc in range(p.shape[4]):
                l = l + p[:, :, :, :, cc]
            for cc in range(p.shape[4]):
                acc = fma(p[:, :, :, :, cc, :, :, None],
                          vt[:, :, :, :, cc, :, None, :], acc)
    # the warp's groups, pairwise at group distances 1, 2, ...
    off = 1
    while off < KPS:
        flip = torch.arange(KPS) ^ off
        l = l + l[:, :, :, :, flip]
        acc = acc + acc[:, :, :, :, flip]
        off *= 2
    l, acc = l[:, :, :, :, 0], acc[:, :, :, :, 0]   # (B,Hkv,Z,W,R[,hd])

    def merge(m_, l_, o_):
        """Merge axis 3 of (m, l, o) in order: (M, L, O)."""
        M = m_.amax(3)
        L = torch.zeros_like(M)
        O = torch.zeros(o_.shape[:3] + o_.shape[4:])
        for w in range(m_.shape[3]):
            f = torch.where(m_[:, :, :, w] == NEG_INF, 0.0,
                            torch.exp(m_[:, :, :, w] - M))
            L = fma(l_[:, :, :, w], f, L)
            O = fma(o_[:, :, :, w], f[..., None], O)
        return M, L, O

    M, L, O = merge(m, l, acc)                      # (B, Hkv, Z, R[, hd])
    if Z > 1:                                       # the splits, in order
        _, L, O = merge(M[:, :, None], L[:, :, None], O[:, :, None])
    O, L = O[:, :, 0], L[:, :, 0]
    out = torch.where((L > 0)[..., None], O / L.clamp_min(1e-38)[..., None],
                      0.0)                          # (B, Hkv, R, hd)
    out = out[:, :, :n_rows].reshape(B, Hkv, Sq, group, hd)
    return out.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hd).to(q.dtype)
