// Fused prox-family worker step for Hopper (sm_90a): the local step of
// every stochastic ProxGD / AccProxGD / ADMM round.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/prox_step/kernel.py :: prox_step_lnp  (body _kernel)
// and computes, for every task j of X (L, n, p), y (L, n), W/Z/Q (L, p),
//
//   acc_j = X_j^T l'(X_j w_j, y_j)
//   g_j   = acc_j / n + l2 * w_j
//   out_j = w_j - eta * (g_j * inv_m + q_j + rho * (w_j - z_j))   (L, p) f32
//
// in the Pallas kernel's order, with l' = pred - y (squared) or
// -y * sigmoid(-y * pred) (logistic, y in {-1, +1}).  n is the rows this
// call sees (a mini-batch).  X may be f32 or bf16; y, W, Z, Q and every
// sum are f32.  eta, rho, inv_m and l2 are kernel arguments: never baked
// into the code, never read from device memory.
//
// Bound: bytes.  The least traffic is L*n*p*sizeof(x) + 4*L*n (y)
// + 16*L*p (W, Z, Q in, out) against ~4*L*n*p flops (a dot and an axpy
// per element of X): 1 flop per byte of f32 X.  So X is read from device
// memory once, the residuals never go there, and neither does the (L, p)
// gradient: the step is an epilogue on the shared-memory accumulator.
//
// Design (mtl_grad.cu's structure, a simple kernel that is right first):
//  * one CTA per task: the sum over rows runs in one block in a fixed
//    order, so the same inputs give the same bits (no atomics), as the
//    reference's sequential row-block accumulator does;
//  * w_j (p floats) and the f32 accumulator (p floats; thread t owns
//    columns t, t + kThreads, ...) live in shared memory;
//  * the block walks tiles of `tile_rows` rows.  Phase 1: warp k takes
//    rows k, k + kWarps, ...; its lanes stream the row from device memory
//    (16-byte loads when rows are 16-byte aligned), write it to the
//    shared-memory tile as f32 and accumulate x_i . w_j; a shuffle tree
//    sums the lanes and lane 0 leaves r_i = l'(pred_i, y_i) in shared
//    memory.  Phase 2: each thread adds sum_i r_i x_i[c] for its columns
//    from the tile;
//  * epilogue: each thread turns its columns of the accumulator into the
//    stepped w_j[c], reading z_j[c] and q_j[c] once.
// Known limit, shared with mtl_grad: one CTA per task leaves SMs idle
// when L is small (L=32 uses 32 of 132 SMs); a row split with a
// deterministic second pass is queued.  The mini-batch gather stays
// outside (the caller indexes X); reading rows through the indices in
// the kernel would halve the bytes and is queued too.
//
// C interface: prox_step_launch() launches on the given stream, does not
// synchronise and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileBytes = 64 * 1024;     // f32 rows staged per tile
constexpr int kMaxTileRows = 64;
constexpr int kMaxSmem = 227 * 1024;      // a Hopper block's shared memory
constexpr int kMaxP = 16384;              // 2p + p floats fit kMaxSmem

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16-byte loads of X: kVec elements decoded to f32.
template <typename TX> struct XVec;

template <> struct XVec<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};

template <> struct XVec<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
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

struct StepParams {
  float eta, rho, inv_m, l2;
};

template <int kLoss, typename TX>
__global__ void __launch_bounds__(kThreads)
prox_step_kernel(const TX* __restrict__ X, const float* __restrict__ y,
                 const float* __restrict__ W, const float* __restrict__ Z,
                 const float* __restrict__ Q, float* __restrict__ out,
                 int n, int p, int tile_rows, int r_pad, bool vec,
                 StepParams sp) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                        // (p,)
  float* acc_s = w_s + p;                   // (p,)
  float* r_s = acc_s + p;                   // (r_pad,) residuals of the tile
  float* x_s = r_s + r_pad;                 // (tile_rows, p) f32 tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t task = blockIdx.x;
  const size_t row0 = task * static_cast<size_t>(p);   // task's W/Z/Q/out row
  const TX* __restrict__ Xj = X + task * static_cast<size_t>(n) * p;
  const float* __restrict__ yj = y + task * static_cast<size_t>(n);

  for (int c = tid; c < p; c += kThreads) {
    w_s[c] = W[row0 + c];
    acc_s[c] = 0.f;
  }
  __syncthreads();

  constexpr int V = XVec<TX>::kVec;
  for (int r0 = 0; r0 < n; r0 += tile_rows) {
    const int rows = min(tile_rows, n - r0);
    // phase 1: stage the tile and leave one residual per row
    for (int i = warp; i < rows; i += kWarps) {
      const TX* __restrict__ xr = Xj + static_cast<size_t>(r0 + i) * p;
      float* xs = x_s + static_cast<size_t>(i) * p;
      float dot = 0.f;
      int c0 = 0;
      if (vec) {
        c0 = (p / V) * V;
        for (int c = lane * V; c < c0; c += 32 * V) {
          float xv[V];
          XVec<TX>::load(xr + c, xv);
#pragma unroll
          for (int e = 0; e < V; e += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(w_s + c + e);
            *reinterpret_cast<float4*>(xs + c + e) =
                make_float4(xv[e], xv[e + 1], xv[e + 2], xv[e + 3]);
            dot = fmaf(xv[e], wv.x, dot);
            dot = fmaf(xv[e + 1], wv.y, dot);
            dot = fmaf(xv[e + 2], wv.z, dot);
            dot = fmaf(xv[e + 3], wv.w, dot);
          }
        }
      }
      for (int c = c0 + lane; c < p; c += 32) {
        const float xe = to_f32(xr[c]);
        xs[c] = xe;
        dot = fmaf(xe, w_s[c], dot);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) r_s[i] = dloss<kLoss>(dot, yj[r0 + i]);
    }
    __syncthreads();
    // phase 2: acc[c] += sum_i r_i x_i[c], rows in order
    for (int c = tid; c < p; c += kThreads) {
      float a = acc_s[c];
      for (int i = 0; i < rows; ++i)
        a = fmaf(r_s[i], x_s[static_cast<size_t>(i) * p + c], a);
      acc_s[c] = a;
    }
    __syncthreads();
  }

  // epilogue: the step, on the columns this thread accumulated
  const float n_rows = static_cast<float>(n);   // the rows this call sees
  for (int c = tid; c < p; c += kThreads) {
    const float w = w_s[c];
    const float g = acc_s[c] / n_rows + sp.l2 * w;
    const float step = g * sp.inv_m + Q[row0 + c] + sp.rho * (w - Z[row0 + c]);
    out[row0 + c] = w - sp.eta * step;
  }
}

template <int kLoss, typename TX>
cudaError_t launch(const void* X, const float* y, const float* W,
                   const float* Z, const float* Q, float* out, int L, int n,
                   int p, StepParams sp, cudaStream_t stream) {
  int tile_rows = kTileBytes / (4 * p);
  tile_rows = tile_rows < 1 ? 1 : (tile_rows > kMaxTileRows ? kMaxTileRows : tile_rows);
  const int r_pad = (tile_rows + 3) & ~3;   // keeps the tile 16-byte aligned
  const size_t smem = (static_cast<size_t>(2) * p + r_pad
                       + static_cast<size_t>(tile_rows) * p) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kern = prox_step_kernel<kLoss, TX>;
  static bool opted_in = false;             // once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  constexpr int V = XVec<TX>::kVec;
  const bool vec = (reinterpret_cast<uintptr_t>(X) & 15u) == 0 && p % V == 0;
  kern<<<L, kThreads, smem, stream>>>(static_cast<const TX*>(X), y, W, Z, Q,
                                      out, n, p, tile_rows, r_pad, vec, sp);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t by_loss(int loss, const void* X, const float* y, const float* W,
                    const float* Z, const float* Q, float* out, int L, int n,
                    int p, StepParams sp, cudaStream_t stream) {
  switch (loss) {
    case 0: return launch<0, TX>(X, y, W, Z, Q, out, L, n, p, sp, stream);
    case 1: return launch<1, TX>(X, y, W, Z, Q, out, L, n, p, sp, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: X 0 = f32, 1 = bf16; loss 0 = squared, 1 = logistic.
// All arrays are dense row-major: X (L, n, p), y (L, n), W/Z/Q/out
// (L, p).  Needs L, n, p >= 1 and p <= kMaxP.
extern "C" int prox_step_launch(const void* X, int x_dtype, const void* y,
                                const void* W, const void* Z, const void* Q,
                                void* out, int L, int n, int p, int loss,
                                float eta, float rho, float inv_m, float l2,
                                void* stream) {
  if (L < 1 || n < 1 || p < 1 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(W);
  const float* zf = static_cast<const float*>(Z);
  const float* qf = static_cast<const float*>(Q);
  float* o = static_cast<float*>(out);
  const StepParams sp{eta, rho, inv_m, l2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_dtype) {
    case 0: err = by_loss<float>(loss, X, yf, wf, zf, qf, o, L, n, p, sp, st); break;
    case 1: err = by_loss<__nv_bfloat16>(loss, X, yf, wf, zf, qf, o, L, n, p, sp, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
