// Per-task loss gradients and the fused prox-family worker step for Hopper
// (sm_90a): one accumulator, two epilogues.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/mtl_grad/kernel.py  :: task_gradients_mnp  (body _kernel)
//   src/repro/kernels/prox_step/kernel.py :: prox_step_lnp       (body _kernel)
// Both sum, for every task j of X (m, n, p), y (m, n), W (m, p),
//
//   acc_j = X_j^T l'(X_j w_j, y_j)
//
// with l' = pred - y (squared) or -y * sigmoid(-y * pred) (logistic,
// y in {-1, +1}), and differ only in what they write:
//
//   mtl_grad_launch:  G[j]   = acc_j / n                          (m, p) f32
//   prox_step_launch: g_j    = acc_j / n + l2 * w_j
//                     out[j] = w_j - eta * (g_j * inv_m + q_j + rho * (w_j - z_j))
//
// n is the rows this call sees (a mini-batch for the step).  X may be f32
// or bf16; y, W, Z, Q and every sum are f32; eta, rho, inv_m and l2 are
// kernel arguments, never read from device memory.
//
// Bound: bytes.  The least traffic is m*n*p*sizeof(x) + 4*m*n (y) plus
// the (m, p) vectors, against 4*m*n*p flops (a dot and an axpy per
// element): 1 flop per byte of f32 X, so tensor cores do not help.  X must
// be read once, at close to the memory rate, and the residuals and the
// gradient must never go to device memory.
//
// Design:
//  * split: a task's T tiles of `tile_rows` consecutive rows are cut into
//    `split` (S in {1, 2, 4, 8}) contiguous ranges, rank k of a thread-block
//    cluster of S taking tiles [k T / S, (k + 1) T / S).  S comes from the
//    wrapper's plan (mtl_grad/kernel.py::plan), so that m S CTAs come close
//    to filling the card when m is small;
//  * feed: a tile is one contiguous span of X, and its labels one of y.
//    One producer thread copies both with 1-D TMA bulk copies into a ring
//    of `stages` shared-memory stages (full and empty mbarriers), so no
//    consumer waits on a load from device memory.  A copy needs 16-byte
//    bounds, so each span is widened to them and clamped inside its
//    tensor; the few bytes the clamp leaves out (at the tensor's own ends)
//    the producer copies itself;
//  * consume: 8 warps.  Phase 1: warp k takes rows k, k + 8, ... of the
//    tile, up to four at a time; lane l sums x_i . w_j over columns l, l + 32,
//    ... (16-byte chunks when rows are 16-byte aligned); a shuffle tree adds
//    the lanes (a reduce-scatter: 6 shuffles for 4 rows, each sum the same
//    tree as a butterfly's), and lane 8u leaves r_i = l'(pred_i, y_i) of the
//    group's u-th row in shared memory.
//    Phase 2, after a named barrier of the 8 warps: thread t adds
//    sum_i r_i x_i[c] for its columns c = t, t + 256, ... (two at a time),
//    rows in order,
//    to its f32 partial in shared memory.  Each warp then releases the
//    stage.  bf16 X is staged as bf16 and converted when read;
//  * combine: after a cluster barrier, rank k sums the S partials of its
//    column slice by reading its peers' shared memory (DSMEM) in rank order
//    0..S-1 and applies the epilogue; a second cluster barrier keeps every
//    CTA resident while its peers read it.
// No atomics and one launch: the order of every sum depends only on the
// shape and the plan, so the same inputs give the same bits.
//
// C interface: mtl_grad_launch() and prox_step_launch() launch on the
// given stream, do not synchronise and allocate nothing; they return the
// launch's CUDA error code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;                     // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;     // and one producer warp
constexpr int kRowsAtOnce = 4;                // phase 1: rows a warp sums together
constexpr int kMaxSmem = 227 * 1024;          // a Hopper block's shared memory
constexpr int kMaxP = 16384;                  // 8p bytes + one row fit kMaxSmem
constexpr int kMaxSplit = 8;                  // the portable cluster size
constexpr int kMaxStages = 8;
constexpr int kMaxTileRows = 256;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory, in bytes; kernel.py::smem_bytes is the same formula.
//   w (p4 f32) | acc (p4 f32) | r (stages x r4 f32) | full, empty
//   mbarriers (stages each) | ring (stages x stage_bytes, from 128), a
//   stage being the tile of X then its y
struct Layout {
  int p4, r4, x_stage, stage_bytes;
  int acc, r, bars, ring, total;
  __host__ __device__ Layout(int p, int tile_rows, int stages, int x_bytes) {
    p4 = (p + 3) & ~3;
    r4 = (tile_rows + 3) & ~3;
    // a span widened to 16-byte bounds is at most 30 bytes longer
    x_stage = ((tile_rows * p * x_bytes + 15) & ~15) + 32;
    stage_bytes = x_stage + ((tile_rows * 4 + 15) & ~15) + 32;
    acc = 4 * p4;
    r = 8 * p4;
    bars = r + 4 * stages * r4;
    ring = (bars + 16 * stages + 127) & ~127;
    total = ring + stages * stage_bytes;
  }
};

struct Shape {
  int n, p, split, tile_rows, stages;
  bool vec;                         // every row of X is 16-byte aligned
  const unsigned char* x_end;       // one past X's last byte (the clamp)
  const unsigned char* y_end;       // one past y's last byte
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// raise the bytes the current phase waits for, without arriving
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool bar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of parity ``parity`` to complete.  A wait that
// outlasts 2^34 clocks (~9 s; a tile takes microseconds) traps, so a
// broken pipeline fails its launch instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!bar_test(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// the consumer warps' barrier, after the prologue and between phase 1 and
// phase 2 (id 1; 0 is __syncthreads')
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// 1-D TMA: ``bytes`` (a multiple of 16) from 16-byte aligned ``src`` to
// 16-byte aligned shared ``dst``, completing on ``bar``
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Stage a tensor's bytes [a, b) so that byte g lands at
// stage[g - floor16(a)], the copy completing on ``full``'s current phase.
// The TMA takes [lo, hi): the span widened to 16-byte bounds, clamped to
// the 16-byte bounds inside the tensor [xb, xe).  The bytes of the span
// outside [lo, hi) (fewer than 16 at each end, only next to the tensor's
// own ends) are copied here, before the producer's arrive releases them.
__device__ void load_span(const unsigned char* a, const unsigned char* b,
                          const unsigned char* xb, const unsigned char* xe,
                          unsigned char* stage, uint32_t full) {
  const uintptr_t ua = reinterpret_cast<uintptr_t>(a);
  const uintptr_t ub = reinterpret_cast<uintptr_t>(b);
  const uintptr_t base = ua & ~uintptr_t{15};
  const uintptr_t xb16 = (reinterpret_cast<uintptr_t>(xb) + 15) & ~uintptr_t{15};
  const uintptr_t xe16 = reinterpret_cast<uintptr_t>(xe) & ~uintptr_t{15};
  const uintptr_t lo = base > xb16 ? base : xb16;
  const uintptr_t ub16 = (ub + 15) & ~uintptr_t{15};
  const uintptr_t hi = ub16 < xe16 ? ub16 : xe16;
  const uintptr_t head = hi > lo ? lo : ub;     // plain copy of [ua, head)
  const uintptr_t tail = hi > lo ? hi : ub;     // and of [tail, ub)
  for (uintptr_t g = ua; g < head; ++g)
    stage[g - base] = *reinterpret_cast<const unsigned char*>(g);
  for (uintptr_t g = tail > ua ? tail : ua; g < ub; ++g)
    stage[g - base] = *reinterpret_cast<const unsigned char*>(g);
  if (hi > lo) {
    bar_expect_tx(full, static_cast<uint32_t>(hi - lo));
    bulk_copy(smem_u32(stage + (lo - base)), reinterpret_cast<const void*>(lo),
              static_cast<uint32_t>(hi - lo), full);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16-byte reads of a staged row: kVec elements decoded to f32.
template <typename TX> struct XVec;

template <> struct XVec<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const float* ptr, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(ptr);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};

template <> struct XVec<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* ptr, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(ptr);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // little endian: element 2i is the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// sigmoid(z) without overflow for large |z|: exp of a non-positive number
__device__ __forceinline__ float stable_sigmoid(float z) {
  if (z >= 0.f) return 1.f / (1.f + expf(-z));
  const float e = expf(z);
  return e / (1.f + e);
}

template <int kLoss>
__device__ __forceinline__ float dloss(float pred, float y) {
  if (kLoss == 0) return pred - y;                  // squared
  return -y * stable_sigmoid(-y * pred);            // logistic
}

// The two epilogues: element i of the (m, p) output from the summed
// accumulator, w_j[c] and the rows this call sees.
struct GradOut {
  float* G;
  __device__ __forceinline__ void operator()(size_t i, float acc, float w,
                                             float n) const {
    G[i] = acc / n;
  }
};

struct StepOut {
  const float* Z;
  const float* Q;
  float* out;
  float eta, rho, inv_m, l2;
  __device__ __forceinline__ void operator()(size_t i, float acc, float w,
                                             float n) const {
    const float g = acc / n + l2 * w;
    const float step = g * inv_m + Q[i] + rho * (w - Z[i]);
    out[i] = w - eta * step;
  }
};

// Lane l's partial sums x_i . w over its columns (l V + 32 V k, V at a
// time, when rows are 16-byte aligned; else l + 32 k) for the R rows at
// xr, xr + stride, ...; of these only the first ``live`` lie in the tile,
// and the rest read the last of those (their sums are dropped).  d[u] for
// u >= R are left as they are.
template <int R, typename TX>
__device__ __forceinline__ void row_dots(const TX* xr, size_t stride, int live,
                                         const float* w_s, int p, int lane,
                                         bool vec, float* d) {
  constexpr int V = XVec<TX>::kVec;
  const TX* row[R];
#pragma unroll
  for (int u = 0; u < R; ++u) row[u] = xr + (u < live ? u : live - 1) * stride;
  if (vec) {
    for (int c = lane * V; c < p; c += 32 * V) {
      float wv[V];
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(w_s + c + e);
        wv[e] = w4.x; wv[e + 1] = w4.y; wv[e + 2] = w4.z; wv[e + 3] = w4.w;
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        float xv[V];
        XVec<TX>::load(row[u] + c, xv);
#pragma unroll
        for (int e = 0; e < V; ++e) d[u] = fmaf(xv[e], wv[e], d[u]);
      }
    }
  } else {
    for (int c = lane; c < p; c += 32) {
      const float wc = w_s[c];
#pragma unroll
      for (int u = 0; u < R; ++u)
        d[u] = fmaf(to_f32(row[u][c]), wc, d[u]);
    }
  }
}

// The sums over the 32 lanes of d[0..3], lane 8u (u < 4) ending with
// row u's.  Each level adds the partner's partial at lane distance 16, 8,
// 4, 2, 1 as a butterfly does, so every sum is the butterfly's, bit for
// bit; but at the first two levels a lane passes on only the rows it
// drops, 6 shuffles in place of 20.
__device__ __forceinline__ float lane_sums(const float* d, int lane) {
  const bool h16 = lane & 16, h8 = lane & 8;
  float a[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    a[j] = (h16 ? d[j + 2] : d[j]) +
           __shfl_xor_sync(kFull, h16 ? d[j] : d[j + 2], 16);
  float v = (h8 ? a[1] : a[0]) + __shfl_xor_sync(kFull, h8 ? a[0] : a[1], 8);
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 1);
  return v;
}

// Phase 2 for the C columns c, c + 256, ...: acc[c] += sum_i r_i x_i[c]
// over the tile's rows, in order.
template <int C, typename TX>
__device__ __forceinline__ void accumulate(float* acc_s, const float* r_s,
                                           const TX* xs, int c, int p,
                                           int rows) {
  float acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = acc_s[c + j * kConsumers];
  int r = 0;
  for (; r + 4 <= rows; r += 4) {
    const float4 rv = *reinterpret_cast<const float4*>(r_s + r);
    const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const TX* xr = xs + static_cast<size_t>(r + e) * p + c;
#pragma unroll
      for (int j = 0; j < C; ++j)
        acc[j] = fmaf(rr[e], to_f32(xr[j * kConsumers]), acc[j]);
    }
  }
  for (; r < rows; ++r) {
    const TX* xr = xs + static_cast<size_t>(r) * p + c;
#pragma unroll
    for (int j = 0; j < C; ++j)
      acc[j] = fmaf(r_s[r], to_f32(xr[j * kConsumers]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < C; ++j) acc_s[c + j * kConsumers] = acc[j];
}

template <int kLoss, typename TX, typename Out>
__global__ void __launch_bounds__(kThreads)
grad_kernel(const TX* __restrict__ X, const float* __restrict__ y,
            const float* __restrict__ W, Shape s, Out out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(s.p, s.tile_rows, s.stages, sizeof(TX));
  float* w_s = reinterpret_cast<float*>(smem);
  float* acc_s = reinterpret_cast<float*>(smem + lay.acc);
  float* r_all = reinterpret_cast<float*>(smem + lay.r);
  const uint32_t full0 = smem_u32(smem + lay.bars);
  const uint32_t empty0 = full0 + 8 * s.stages;
  unsigned char* ring = smem + lay.ring;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t task = blockIdx.x / s.split;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_bytes = static_cast<size_t>(s.p) * sizeof(TX);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(X);
  const unsigned char* Xj = xb + task * s.n * row_bytes;
  const unsigned char* yb = reinterpret_cast<const unsigned char*>(y);
  const unsigned char* yj = yb + task * s.n * sizeof(float);
  const int n_tiles = (s.n + s.tile_rows - 1) / s.tile_rows;
  const int t_begin = static_cast<int>(static_cast<long long>(rank) * n_tiles / s.split);
  const int t_end = static_cast<int>(static_cast<long long>(rank + 1) * n_tiles / s.split);

  if (tid == 0) {
    for (int i = 0; i < s.stages; ++i) {
      bar_init(full0 + 8 * i, 1);
      bar_init(empty0 + 8 * i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // producer: one thread stages every tile of this rank's range
    if (lane == 0) {
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin;
        const int st = i % s.stages;
        bar_wait(empty0 + 8 * st, ((i / s.stages) & 1) ^ 1);
        const int r0 = t * s.tile_rows;
        const int rows = min(s.tile_rows, s.n - r0);
        const unsigned char* a = Xj + static_cast<size_t>(r0) * row_bytes;
        const unsigned char* ya = yj + static_cast<size_t>(r0) * sizeof(float);
        unsigned char* stage = ring + static_cast<size_t>(st) * lay.stage_bytes;
        load_span(a, a + static_cast<size_t>(rows) * row_bytes, xb, s.x_end,
                  stage, full0 + 8 * st);
        load_span(ya, ya + rows * sizeof(float), yb, s.y_end,
                  stage + lay.x_stage, full0 + 8 * st);
        bar_arrive(full0 + 8 * st);
      }
    }
  } else {
    // w and the partial, while the producer's first copies are in flight
    for (int c = tid; c < s.p; c += kConsumers) {
      w_s[c] = W[task * s.p + c];
      acc_s[c] = 0.f;
    }
    consumers_sync();
    for (int t = t_begin; t < t_end; ++t) {
      const int i = t - t_begin;
      const int st = i % s.stages;
      const int r0 = t * s.tile_rows;
      const int rows = min(s.tile_rows, s.n - r0);
      const uintptr_t a = reinterpret_cast<uintptr_t>(Xj + static_cast<size_t>(r0) * row_bytes);
      const uintptr_t ya = reinterpret_cast<uintptr_t>(yj + static_cast<size_t>(r0) * sizeof(float));
      const unsigned char* stage = ring + static_cast<size_t>(st) * lay.stage_bytes;
      const TX* xs = reinterpret_cast<const TX*>(stage + (a & 15));
      const float* ys = reinterpret_cast<const float*>(stage + lay.x_stage + (ya & 15));
      float* r_s = r_all + st * lay.r4;
      bar_wait(full0 + 8 * st, (i / s.stages) & 1);

      // phase 1: one residual per row
      for (int k0 = 0; warp + kWarps * k0 < rows; k0 += kRowsAtOnce) {
        // this warp's rows of the group that lie in the tile (warp-uniform)
        const int live = min(kRowsAtOnce, (rows - warp - kWarps * k0 + kWarps - 1) / kWarps);
        const TX* xr = xs + static_cast<size_t>(warp + kWarps * k0) * s.p;
        const size_t stride = static_cast<size_t>(kWarps) * s.p;
        float d[kRowsAtOnce];
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u) d[u] = 0.f;
        if (live > 2)
          row_dots<4>(xr, stride, live, w_s, s.p, lane, s.vec, d);
        else if (live > 1)
          row_dots<2>(xr, stride, live, w_s, s.p, lane, s.vec, d);
        else
          row_dots<1>(xr, stride, live, w_s, s.p, lane, s.vec, d);
        const float pred = lane_sums(d, lane);
        const int u = lane >> 3;
        if ((lane & 7) == 0 && u < live) {
          const int row = warp + kWarps * (k0 + u);
          r_s[row] = dloss<kLoss>(pred, ys[row]);
        }
      }
      consumers_sync();

      // phase 2: acc[c] += sum_i r_i x_i[c], rows in order
      for (int c = tid; c < s.p; c += 2 * kConsumers) {
        if (c + kConsumers < s.p)
          accumulate<2>(acc_s, r_s, xs, c, s.p, rows);
        else
          accumulate<1>(acc_s, r_s, xs, c, s.p, rows);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty0 + 8 * st);
    }
  }
  __syncwarp();

  // combine: rank k owns columns [k cs, (k + 1) cs); the partials in rank order
  cluster.sync();
  const int cs = (s.p + s.split - 1) / s.split;
  const int c_end = min(s.p, (rank + 1) * cs);
  const float n_rows = static_cast<float>(s.n);   // the rows this call sees
  for (int c = rank * cs + tid; c < c_end; c += kThreads) {
    float v = cluster.map_shared_rank(acc_s, 0)[c];
    for (int q = 1; q < s.split; ++q) v += cluster.map_shared_rank(acc_s, q)[c];
    out(task * s.p + c, v, w_s[c], n_rows);
  }
  cluster.sync();                      // peers may still read this CTA's partial
}

template <int kLoss, typename TX, typename Out>
cudaError_t launch(const void* X, const float* y, const float* W, Out out,
                   int m, int n, int p, int split, int tile_rows, int stages,
                   cudaStream_t stream) {
  if (split != 1 && split != 2 && split != 4 && split != kMaxSplit)
    return cudaErrorInvalidValue;
  if (tile_rows < 1 || tile_rows > kMaxTileRows || stages < 1 ||
      stages > kMaxStages)
    return cudaErrorInvalidValue;
  const Layout lay(p, tile_rows, stages, sizeof(TX));
  if (lay.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = grad_kernel<kLoss, TX, Out>;
  static bool opted_in = false;              // once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m) * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster of `split` CTAs of this shared memory must fit on the card;
  // remember the largest that did, per split
  static int schedulable[kMaxSplit + 1] = {};
  if (lay.total > schedulable[split]) {
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    schedulable[split] = lay.total;
  }
  const TX* Xt = static_cast<const TX*>(X);
  const Shape s{n, p, split, tile_rows, stages,
                (reinterpret_cast<uintptr_t>(X) & 15u) == 0 &&
                    (static_cast<size_t>(p) * sizeof(TX)) % 16 == 0,
                reinterpret_cast<const unsigned char*>(
                    Xt + static_cast<size_t>(m) * n * p),
                reinterpret_cast<const unsigned char*>(
                    y + static_cast<size_t>(m) * n)};
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, Xt, y, W, s, out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename Out>
cudaError_t dispatch(int x_dtype, int loss, const void* X, const void* y,
                     const void* W, Out out, int m, int n, int p, int split,
                     int tile_rows, int stages, void* stream) {
  if (m < 1 || n < 1 || p < 1 || p > kMaxP) return cudaErrorInvalidValue;
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = 2 * x_dtype + loss;
  if (x_dtype < 0 || x_dtype > 1 || loss < 0 || loss > 1)
    return cudaErrorInvalidValue;
  switch (code) {
    case 0: return launch<0, float>(X, yf, wf, out, m, n, p, split, tile_rows, stages, st);
    case 1: return launch<1, float>(X, yf, wf, out, m, n, p, split, tile_rows, stages, st);
    case 2: return launch<0, __nv_bfloat16>(X, yf, wf, out, m, n, p, split, tile_rows, stages, st);
    default: return launch<1, __nv_bfloat16>(X, yf, wf, out, m, n, p, split, tile_rows, stages, st);
  }
}

}  // namespace

// dtype codes: X 0 = f32, 1 = bf16; loss 0 = squared, 1 = logistic.
// All arrays are dense row-major: X (m, n, p), y (m, n), W/Z/Q and the
// output (m, p).  Needs m, n, p >= 1 and p <= kMaxP.  The plan (split,
// tile_rows, stages) is kernel.py::plan's; the launch refuses one whose
// shared memory exceeds a block's or whose cluster cannot be scheduled.
extern "C" int mtl_grad_launch(const void* X, int x_dtype, const void* y,
                               const void* W, void* G, int m, int n, int p,
                               int loss, int split, int tile_rows, int stages,
                               void* stream) {
  const GradOut out{static_cast<float*>(G)};
  return static_cast<int>(dispatch(x_dtype, loss, X, y, W, out, m, n, p,
                                   split, tile_rows, stages, stream));
}

extern "C" int prox_step_launch(const void* X, int x_dtype, const void* y,
                                const void* W, const void* Z, const void* Q,
                                void* out, int L, int n, int p, int loss,
                                float eta, float rho, float inv_m, float l2,
                                int split, int tile_rows, int stages,
                                void* stream) {
  const StepOut step{static_cast<const float*>(Z), static_cast<const float*>(Q),
                     static_cast<float*>(out), eta, rho, inv_m, l2};
  return static_cast<int>(dispatch(x_dtype, loss, X, y, W, step, L, n, p,
                                   split, tile_rows, stages, stream));
}
