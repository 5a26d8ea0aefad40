"""A plain emulation of the summation order of the port's gradient
accumulator (``src_torch/repro_torch/kernels/mtl_grad/csrc/mtl_grad.cu``,
the kernel behind both ``mtl_grad`` and ``prox_step``), for the CPU
tests, which cannot run the kernel.

Per task, each rank of the cluster walks its tiles (``kernel.row_ranges``)
in order.  For each row, lane l of a warp sums x_i . w over its columns
with fused multiply-adds (16-byte chunks l V + 32 V k when rows are
16-byte aligned, else columns l + 32 k), and the 32 lane sums are added
pairwise at lane distances 16, 8, 4, 2, 1; r_i = l'(pred_i, y_i).  Each
column's partial then takes r_i x_i[c] with a fused multiply-add, rows in
order.  The S partials are added in rank order, then the epilogue.

A fused multiply-add is emulated in float64: the product of two f32
values is exact there, and the sum is rounded to f64, then to f32 (a
double rounding that can differ from the card's single one in the last
bit, far inside the tests' 1e-5).
"""
import torch

LANES = 32


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def row_dots(x, w, vec):
    """x (R, p) rows in their stored dtype, w (R, p) f32 (each row's
    task's weights) -> (R,) f32."""
    R, p = x.shape
    V = 16 // x.element_size() if vec else 1
    xf, lanes = x.float(), torch.zeros(R, LANES)
    lane = torch.arange(LANES)
    zero = torch.zeros(())
    for k in range(-(-p // (LANES * V))):
        for e in range(V):
            cols = lane * V + LANES * V * k + e
            live = cols < p
            c = cols.clamp(max=p - 1)
            lanes = fma(torch.where(live, xf[:, c], zero),
                        torch.where(live, w[:, c], zero), lanes)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, lane ^ off]
    return lanes[:, 0]


def dloss(pred, y, loss):
    if loss == "squared":
        return pred - y
    z = -y * pred                       # the kernel's stable sigmoid
    sig = torch.where(z >= 0, 1 / (1 + torch.exp(-z)),
                      torch.exp(z) / (1 + torch.exp(z)))
    return -y * sig


def accumulate(X, y, W, loss, ranges, tile_rows):
    """X (m, n, p) f32/bf16, y (m, n), W (m, p) f32 and each rank's rows
    (``kernel.row_ranges``) -> the (m, p) f32 sums X_jᵀ l'(X_j w_j, y_j)
    in the kernel's order."""
    m, n, p = X.shape
    vec = (p * X.element_size()) % 16 == 0     # X itself 16-byte aligned
    partials = []
    for r0, r1 in ranges:
        acc = torch.zeros(m, p)
        for t0 in range(r0, r1, tile_rows):
            t1 = min(t0 + tile_rows, r1)
            rows = X[:, t0:t1]
            pred = row_dots(rows.reshape(-1, p),
                            W.repeat_interleave(t1 - t0, 0), vec)
            r = dloss(pred.reshape(m, t1 - t0), y[:, t0:t1], loss)
            for i in range(t1 - t0):
                acc = fma(r[:, i:i + 1], rows[:, i].float(), acc)
        partials.append(acc)
    total = partials[0]
    for part in partials[1:]:
        total = total + part
    return total


def step_out(total, n, W, Z, Q, eta, rho, inv_m, l2):
    """The step epilogue in the kernel's order."""
    g = total / n + l2 * W
    return W - eta * (g * inv_m + Q + rho * (W - Z))
