// Mamba-1 selective scan for Hopper (sm_90a): every SSM scan of the
// falcon-mamba serving path (cache-free forward, prefill, decode step).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssm_scan/kernel.py :: selective_scan_bsin  (body _kernel)
// and computes, for x, dt (B, S, I), B_t, C_t (B, S, N), A (I, N) and an
// optional carried state h0 (B, I, N) (zeros when absent),
//
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) B_t^T      (I, N) per row
//   y_t = h_t C_t                                             (I,)
//
// returning y (B, S, I) f32 and h_final = h_S (B, I, N) f32.  x, B_t and
// C_t may be f32 or bf16 (each pair of types is instantiated), dt and A
// are f32; all arithmetic is f32.  With h0 this is the reference's
// carried-state branch (models/ssm.py's lax.scan from `state`), which its
// Pallas kernel does not take: so the cache-free forward, a prefill from
// the serving engine's zero state and every decode step (S = 1) all run
// this one kernel.
//
// Bound.  The least traffic is x, dt read once and y written once per
// (b, t, i) -- 10 bytes with bf16 x -- plus B_t, C_t, A, h0 and h_final,
// which are small.  The work is B*S*I*N exponentials and ~6 f32 flops
// per (b, t, i, n).  At the served prefill shape (8, 2048, 8192, 16):
// 1.34 GB, 0.40 ms at 3.35 TB/s; 2.15e9 exponentials, 0.51 ms at the
// SFU's 16 a clock on each of 132 SMs.  So the exponentials bound it
// (operations), and the (B, S, I, N) trajectory must never reach
// device memory: the TPU kernel's point, kept here.
//
// Design (a simple kernel that is right first):
//  * one thread per (b, i) keeps its N <= 16 states and its row of A in
//    registers for the whole sequence, so the sequential axis, which the
//    TPU kernel runs as an ordered grid axis with the state in VMEM
//    scratch, is a loop inside the thread;
//  * a block of 128 threads covers 128 neighbouring channels of one row,
//    so each step's x and dt loads and y stores are coalesced across i;
//  * B_t and C_t of a chunk of 64 steps are staged once per block in
//    shared memory as f32 and read by all threads as broadcasts (they
//    are shared by all i of a row); they are read through their strides,
//    so slices of the x_proj output need no copy;
//  * latency: the x and dt loads of the next 8 steps are issued before
//    the math of the current 8, so no step waits a memory round trip;
//  * y_t is reduced over n in registers (no cross-thread reduction) and
//    h_final is written once, at the end;
//  * exp is the accurate expf (no fast math), as in the reference;
//  * deterministic: no atomics, one fixed order, a relaunch is bitwise
//    equal.  h0 is read before h_final is written by the same thread, so
//    h_out may alias h0 (each (b, i, n) has one owner); the wrapper does
//    not use that today.
// Known limit: B*I threads (65 536 at B=8, I=8192: ~500 a SM) leave the
// card at a quarter of its thread slots; splitting N over 2-4 threads
// with a shuffle reduce for y is the lever if the times ask for it.
//
// C interface: ssm_scan_launch() launches on the given stream, does not
// synchronise and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels of one row per block
constexpr int kChunk = 64;      // steps of B_t, C_t staged at once
constexpr int kGroup = 8;       // steps of x, dt loaded ahead of their math
static_assert(kChunk % kGroup == 0, "groups must not straddle chunks");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// x and dt of steps t0 .. t0 + kGroup - 1 of this thread's channel; 0
// past the end of the sequence or for a channel past I
template <typename TX>
__device__ __forceinline__ void load_group(const TX* __restrict__ xc,
                                           const float* __restrict__ dc,
                                           int t0, int S, int I, bool live,
                                           float* xv, float* dv) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int t = t0 + u;
    const bool ok = live && t < S;
    xv[u] = ok ? to_f32(xc[(int64_t)t * I]) : 0.f;
    dv[u] = ok ? dc[(int64_t)t * I] : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float* v) {
#pragma unroll
  for (int n = 0; n < N; n += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + n);
    v[n] = q.x; v[n + 1] = q.y; v[n + 2] = q.z; v[n + 3] = q.w;
  }
}

template <int N, typename TX, typename TBC>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const TBC* __restrict__ Bc, const TBC* __restrict__ Cc,
                const float* __restrict__ A, const float* h0,
                float* __restrict__ y, float* h_out, int S, int I,
                int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st) {
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < I;
  const int64_t state = ((int64_t)b * I + i) * N;     // (b, i, 0) of h

  float a[N], h[N];
  if (live) {
    load_row<N>(A + (int64_t)i * N, a);
    if (h0 != nullptr) {
      load_row<N>(h0 + state, h);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = 0.f;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) { a[n] = 0.f; h[n] = 0.f; }
  }

  const int64_t row = (int64_t)b * S * I + i;          // (b, 0, i)
  const TX* xc = x + row;
  const float* dc = dt + row;
  float* yc = y + row;
  const TBC* bb = Bc + b * b_sb;
  const TBC* cb = Cc + b * c_sb;

  float xn[kGroup], dn[kGroup];
  load_group(xc, dc, 0, S, I, live, xn, dn);

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int L = min(kChunk, S - t0);
    __syncthreads();                       // the last chunk's reads are done
    for (int k = threadIdx.x; k < L * N; k += kThreads) {
      const int t = k / N, n = k % N;
      bs[t][n] = to_f32(bb[(int64_t)(t0 + t) * b_st + n]);
      cs[t][n] = to_f32(cb[(int64_t)(t0 + t) * c_st + n]);
    }
    __syncthreads();

    for (int g = 0; g < L; g += kGroup) {
      float xv[kGroup], dv[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) { xv[u] = xn[u]; dv[u] = dn[u]; }
      load_group(xc, dc, t0 + g + kGroup, S, I, live, xn, dn);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int t = g + u;
        if (t < L) {                       // the same for every thread
          const float d = dv[u];
          const float dx = d * xv[u];
          float acc = 0.f;
#pragma unroll
          for (int n = 0; n < N; ++n) {
            const float decay = expf(d * a[n]);
            h[n] = decay * h[n] + dx * bs[t][n];
            acc += h[n] * cs[t][n];
          }
          if (live) yc[(int64_t)(t0 + t) * I] = acc;
        }
      }
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < N; n += 4)
      *reinterpret_cast<float4*>(h_out + state + n) =
          make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
  }
}

template <int N, typename TX, typename TBC>
void launch_typed(const void* x, const float* dt, const void* Bc,
                  const void* Cc, const float* A, const float* h0, float* y,
                  float* h_out, int B, int S, int I, int64_t b_sb,
                  int64_t b_st, int64_t c_sb, int64_t c_st,
                  cudaStream_t stream) {
  const dim3 grid((I + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<N, TX, TBC><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), dt, static_cast<const TBC*>(Bc),
      static_cast<const TBC*>(Cc), A, h0, y, h_out, S, I, b_sb, b_st, c_sb,
      c_st);
}

template <int N>
void launch_n(int x_dtype, int bc_dtype, const void* x, const float* dt,
              const void* Bc, const void* Cc, const float* A,
              const float* h0, float* y, float* h_out, int B, int S, int I,
              int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st,
              cudaStream_t stream) {
#define SSM_ARGS x, dt, Bc, Cc, A, h0, y, h_out, B, S, I, b_sb, b_st, c_sb, c_st, stream
  if (x_dtype == 0 && bc_dtype == 0) launch_typed<N, float, float>(SSM_ARGS);
  else if (x_dtype == 0) launch_typed<N, float, __nv_bfloat16>(SSM_ARGS);
  else if (bc_dtype == 0) launch_typed<N, __nv_bfloat16, float>(SSM_ARGS);
  else launch_typed<N, __nv_bfloat16, __nv_bfloat16>(SSM_ARGS);
#undef SSM_ARGS
}

}  // namespace

// x_dtype, bc_dtype: 0 float32, 1 bfloat16.  x, dt, y: (B, S, I)
// contiguous; Bc, Cc: (B, S, N) with unit stride over N and the given
// batch and step strides (elements); A: (I, N) and h0, h_out: (B, I, N),
// contiguous and 16-byte aligned; h0 may be null (zeros).  N is 4, 8 or
// 16 (cudaErrorInvalidValue otherwise).
extern "C" int ssm_scan_launch(const void* x, const float* dt, const void* Bc,
                               const void* Cc, const float* A,
                               const float* h0, float* y, float* h_out,
                               int x_dtype, int bc_dtype, int B, int S, int I,
                               int N, int64_t b_sb, int64_t b_st,
                               int64_t c_sb, int64_t c_st, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSM_ARGS x_dtype, bc_dtype, x, dt, Bc, Cc, A, h0, y, h_out, B, S, I, b_sb, b_st, c_sb, c_st, st
  switch (N) {
    case 4: launch_n<4>(SSM_ARGS); break;
    case 8: launch_n<8>(SSM_ARGS); break;
    case 16: launch_n<16>(SSM_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSM_ARGS
  return static_cast<int>(cudaGetLastError());
}
