"""A plain emulation of the arithmetic order of the port's selective-scan
kernel (``src_torch/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu``), for
the CPU tests, which cannot run the kernel.

A channel's N states are split over Q = N / P lanes, P states a lane.
Per step, each lane takes a2 = A log2 e (rounded once, at the start),
decay = 2^(fma(dt, a2, 1)) / 2 (the card's ex2 of the shifted argument,
rounded to f32; below 2^-126 it flushes to 0), h = fma(decay, h,
(dt x) B) and its partial sum of h C over its P states, in order, by
fused multiply-adds from 0.  The Q partials are then added in the
reduce-scatter's fixed tree: p0 + p1 for Q = 2, (p0 + p2) + (p1 + p3)
for Q = 4.  (The kernel carries h scaled by powers of 2 within a chunk,
so that it never halves the ex2; that scaling is exact and is not
emulated.)

A fused multiply-add is emulated in float64: the product of two f32
values is exact there, and the sum is rounded to f64, then to f32 (a
double rounding that can differ from the card's single one in the last
bit).  2^v is taken in float64 and rounded to f32 (the card's ex2 is
within 2 ulp of it).
"""
import torch

LOG2E = 1.4426950408889634
TREE = {1: ((0,),), 2: ((0, 1),), 4: ((0, 2), (1, 3))}


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def lane_tree(parts):
    """parts (Q, ...) f32 -> their sum in the kernel's order."""
    pairs = [parts[i] + parts[j] if j != i else parts[i]
             for i, j in ((p[0], p[-1]) for p in TREE[len(parts)])]
    return pairs[0] if len(pairs) == 1 else pairs[0] + pairs[1]


def scan(x, dt, Bc, Cc, A, h0, P):
    """x, dt (B, S, I); Bc, Cc (B, S, N); A (I, N); h0 (B, I, N) or None
    -> (y (B, S, I), h_final (B, I, N)), f32, in the kernel's order with
    P states a lane."""
    f32 = torch.float32
    B, S, I = x.shape
    N = Bc.shape[-1]
    Q = N // P
    a2 = (A.to(f32) * torch.tensor(LOG2E, dtype=f32)).to(f32)   # (I, N)
    h = (torch.zeros(B, I, N) if h0 is None else h0.to(f32).clone())
    y = torch.empty(B, S, I)
    tiny = 2.0 ** -126
    for t in range(S):
        d = dt[:, t].to(f32)                                       # (B, I)
        dx = d * x[:, t].to(f32)
        arg = fma(d[:, :, None].expand(B, I, N), a2.expand(B, I, N),
                  torch.ones(()))
        twice = torch.exp2(arg.double()).float()
        decay = torch.where(twice < tiny, torch.zeros_like(twice), twice) / 2
        bx = dx[:, :, None] * Bc[:, t].to(f32)[:, None, :]         # (B, I, N)
        h = fma(decay, h, bx)
        c = Cc[:, t].to(f32)[:, None, :].expand(B, I, N)
        parts = []
        for q in range(Q):
            acc = torch.zeros(B, I)
            for n in range(q * P, (q + 1) * P):
                acc = fma(h[..., n], c[..., n], acc)
            parts.append(acc)
        y[:, t] = lane_tree(parts)
    return y, h
