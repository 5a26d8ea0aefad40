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
// with h_final = h_S (B, I, N) f32.  One kernel template, two entry points:
//
//  * ssm_scan_launch, the bare scan: dt and A given (f32), y written as
//    (B, S, I) f32.  x, B_t and C_t may be f32 or bf16 (each pair of types
//    is instantiated).
//  * mamba_scan_launch, the Mamba mixer's scan with its elementwise chain
//    fused in, all inputs in the model's dtype T (f32 or bf16):
//      prologue  dt = softplus(dt_lin + dt_bias) in f32 (torch's softplus,
//                beta 1, threshold 20), A = -exp(A_log);
//      epilogue  out = T(T(y + D x) * T(silu(z))), rounding where the
//                plain PyTorch chain rounds (models/ssm.py).
//    The (B, S, I) f32 dt and y never reach device memory.  z is read
//    through its batch and step strides (the second half of in_proj's
//    output, no copy).
// All arithmetic is f32.  With h0 this is the reference's carried-state
// branch, which its Pallas kernel does not take: so the cache-free
// forward, a prefill from the serving engine's zero state and every
// decode step (S = 1) all run this one kernel.
//
// Bound.  Bare: x, dt read and y written once per (b, t, i) -- 10 bytes
// with bf16 x -- plus B_t, C_t, A, h0 and h_final; B*S*I*N exponentials.
// At the served prefill shape (8, 2048, 8192, 16): 1.34 GB, 0.40 ms at
// 3.35 TB/s; 2.15e9 exponentials, 0.51 ms at the SFU's 16 a clock on each
// of 132 SMs: operations bound.  Fused: x, dt_lin, z read and out written,
// 8 bytes per (b, t, i) in bf16 (0.32 ms), and per (b, t, i) 3 more
// special-function ops beside the N exponentials (the softplus's exp --
// its log1p is a polynomial on the FMA pipe -- and the SiLU's exp and
// its division's reciprocal, as the SASS has them): 19 at N = 16, 0.61
// ms at the served shape, operations bound too.  Decode (S = 1): h0 read
// and h_final written, 8.4 MB: bytes bound (2.5 us).  The (B, S, I, N)
// trajectory never reaches device memory: the TPU kernel's point, kept
// here.
//
// Design, against those bounds:
//  * the N states of one channel are split over Q = N / P lanes of a warp
//    (P = 4 or 8 states a lane, in registers with the lane's part of A
//    pre-scaled by log2 e; kernel.py's plan takes P = 8 where the grid
//    fills the card, as at the served batch of 8): 2-4x the threads of
//    one thread a channel;
//  * one exponential is one MUFU.EX2 (ex2.approx.ftz of dt * A log2 e + 1,
//    twice the decay: see twice_decay for why the + 1; the state carries
//    the factor 2 as an exact power-of-2 scaling within a chunk): a step
//    costs the SFU op and, per state, the FFMA of its argument, the FMUL
//    of dt x B and two FFMAs, so the SFU and the issue rate are close to
//    even;
//  * y_t is reduced over the Q lanes by a reduce-scatter over Q steps:
//    each lane keeps Q partial sums (its P states, in order), and after
//    log2 Q shuffle rounds lane q holds step q's sum, added in one fixed
//    tree ((p0 + p2) + (p1 + p3) for Q = 4), so a relaunch is bitwise
//    equal and each output is finished by exactly one lane;
//  * a block is 64 channels of one row (64 Q threads).  Chunks of 16 steps
//    of x, dt (or dt_lin), z, B_t and C_t are copied with cp.async into a
//    2-stage ring in shared memory (16-byte copies where the row is
//    aligned and whole, element copies at a ragged edge), read through
//    their strides; the next chunk flies while this one is computed;
//  * the prologue runs once per (t, i) over the whole block (not once per
//    lane), into an f32 (dt, dt x) tile; B_t, C_t go to f32 in the order
//    the lanes read them; the epilogue runs in the one lane that holds
//    y_t, and stores straight to device memory (a warp writes whole
//    32-byte sectors);
//  * decode (S = 1): each lane reads its h0 and writes its h_final as
//    P / 4 float4s, neighbouring lanes on neighbouring addresses; only the
//    live steps of a chunk are staged and scanned;
//  * deterministic: no atomics.  h0 is read by the same thread that later
//    writes the same elements of h_out, so h_out may alias h0 (the
//    serving path writes the state in place).
//
// C interface: each entry takes one record of int64s (LaunchArgs),
// launches on the stream it names, does not synchronise and allocates
// nothing; it returns cudaGetLastError(), or cudaErrorInvalidValue for an
// N or P it was not built for, or cudaErrorMisalignedAddress when A, h0
// or h_out is not 16-byte aligned.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;   // channels of one row per block
constexpr int kChunk = 16;      // steps staged at once
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 2^v, one MUFU.EX2; results below 2^-126 flush to 0 (they scale a state
// by less than 1e-38)
__device__ __forceinline__ float exp2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Twice the decay, 2 exp(dt a) = 2^(dt a2 + 1) with a2 = a log2 e.  MUFU.EX2
// reads its argument as fixed point: a small negative dt a2 (a decay near
// 1, the long memory of the state) loses its low bits there, always the
// same way, and 2048 decays in a row carry that bias into the state (the
// unshifted form fails the check against the plain version: scan_ab.py
// --variants).  dt a2 + 1 in (0, 1] is exact in that form, so only
// decays below 1/2 (whose products die out within a few steps) see the
// truncation.  The factor 2 is carried by the state (see pow2).
__device__ __forceinline__ float twice_decay(float dt, float a2) {
  return exp2_ftz(fmaf(dt, a2, 1.f));
}

// 2^e for the exponents a chunk uses (|e| <= kChunk): exact scalings
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(gmem), "n"(BYTES) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows [0, rows) of a [kChunk][W] tile of T: row r is step t0 + r of the
// batch row at src (step stride st), columns col0 .. col0 + W of ncols;
// zeros past the sequence and past ncols.  Whole, aligned pieces go by
// cp.async, the rest element by element.
template <typename T, int W>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int64_t st,
                                           int rows, int t0, int S, int col0,
                                           int ncols, int tid, int nthreads) {
  constexpr int kV = (16 / (int)sizeof(T)) < W ? 16 / (int)sizeof(T) : W;
  constexpr int kPieces = W / kV;
  static_assert(W % kV == 0, "a row is whole pieces");
  for (int k = tid; k < rows * kPieces; k += nthreads) {
    const int r = k / kPieces, c = (k % kPieces) * kV;
    const int t = t0 + r, col = col0 + c;
    T* d = dst + r * W + c;
    if (t < S) {
      const T* g = src + (int64_t)t * st + col;
      if (col + kV <= ncols &&
          (reinterpret_cast<uintptr_t>(g) % (kV * sizeof(T))) == 0) {
        cp_async<kV * (int)sizeof(T)>(d, g);
      } else {
#pragma unroll
        for (int v = 0; v < kV; ++v) d[v] = col + v < ncols ? g[v] : from_f32<T>(0.f);
      }
    } else {
#pragma unroll
      for (int v = 0; v < kV; ++v) d[v] = from_f32<T>(0.f);
    }
  }
}

// v[0 .. Q): this lane's partial sums of Q consecutive steps; returns the
// full sum of step q over the Q lanes of the channel (lanes q ^ m are the
// partners).  Round m keeps the half of the steps whose bit m is q's and
// sends the other half: ((p0 + p2) + (p1 + p3)) for Q = 4.
template <int Q>
__device__ __forceinline__ float reduce_scatter(float (&v)[Q], int q) {
#pragma unroll
  for (int m = Q / 2; m >= 1; m /= 2) {
    const bool hi = (q & m) != 0;
#pragma unroll
    for (int j = 0; j < m; ++j) {
      const float keep = hi ? v[m + j] : v[j];
      const float send = hi ? v[j] : v[m + j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  return v[0];
}

template <int P>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
#pragma unroll
  for (int n = 0; n < P; n += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + n);
    v[n] = q.x; v[n + 1] = q.y; v[n + 2] = q.z; v[n + 3] = q.w;
  }
}

struct ScanArgs {
  const void* x; const void* dt; const void* z;
  const void* Bc; const void* Cc;
  const float* A;          // A (bare) or A_log (fused), (I, N)
  const float* dt_bias;    // (I,), fused only
  const float* D;          // (I,), fused only
  const float* h0;         // (B, I, N) or null
  void* out;               // (B, S, I): y f32 (bare) or out T (fused)
  float* h_out;            // (B, I, N); may alias h0
  int S, I;
  int64_t x_sb, x_st, d_sb, d_st, z_sb, z_st, b_sb, b_st, c_sb, c_st;
};

template <int N, bool kFused, typename TX, typename TD, typename TBC>
struct Stage {
  alignas(16) TX x[kChunk][kChannels];
  alignas(16) TD d[kChunk][kChannels];
  alignas(16) TX z[kFused ? kChunk : 1][kChannels];
  alignas(16) TBC b[kChunk][N];
  alignas(16) TBC c[kChunk][N];
};

// N states, P a lane (Q = N / P lanes a channel, 64 Q threads a block).
// Bare: TD = float, TO = float.  Fused: TD = TO = TX = TBC = T.
template <int N, int P, bool kFused, typename TX, typename TD, typename TBC,
          typename TO>
__global__ void __launch_bounds__(kChannels * (N / P), (N / P) == 4 ? 4 : 8)
ssm_scan_kernel(const ScanArgs a) {
  constexpr int Q = N / P;
  constexpr int kThreads = kChannels * Q;
  static_assert(P % 4 == 0 && N % P == 0 && kChunk % Q == 0, "shapes");
  using StageT = Stage<N, kFused, TX, TD, TBC>;
  __shared__ StageT ring[2];
  __shared__ float2 dd[kChunk][kChannels];        // (dt, dt x) per step
  __shared__ __align__(16) float bc[kChunk][Q][2 * P];  // a lane's B_t, C_t

  const int S = a.S, I = a.I;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int lc = tid / Q, q = tid % Q;              // channel, lane in it
  const int i = i0 + lc;
  const bool live = i < I;
  const int pc = tid % kChannels;                   // prologue channel
  const int pi = i0 + pc;

  const TX* xg = static_cast<const TX*>(a.x) + b * a.x_sb;
  const TD* dg = static_cast<const TD*>(a.dt) + b * a.d_sb;
  const TX* zg = kFused ? static_cast<const TX*>(a.z) + b * a.z_sb : nullptr;
  const TBC* bg = static_cast<const TBC*>(a.Bc) + b * a.b_sb;
  const TBC* cg = static_cast<const TBC*>(a.Cc) + b * a.c_sb;

  auto stage = [&](int slot, int t0) {
    const int rows = min(kChunk, S - t0);
    const int rq = (rows + Q - 1) / Q * Q;          // whole lane groups
    StageT& s = ring[slot];
    stage_tile<TX, kChannels>(&s.x[0][0], xg, a.x_st, rq, t0, S, i0, I, tid, kThreads);
    stage_tile<TD, kChannels>(&s.d[0][0], dg, a.d_st, rq, t0, S, i0, I, tid, kThreads);
    if constexpr (kFused)
      stage_tile<TX, kChannels>(&s.z[0][0], zg, a.z_st, rq, t0, S, i0, I, tid, kThreads);
    stage_tile<TBC, N>(&s.b[0][0], bg, a.b_st, rq, t0, S, 0, N, tid, kThreads);
    stage_tile<TBC, N>(&s.c[0][0], cg, a.c_st, rq, t0, S, 0, N, tid, kThreads);
  };

  const int n_chunks = (S + kChunk - 1) / kChunk;
  stage(0, 0);
  cp_async_commit();
  if (n_chunks > 1) stage(1, kChunk);
  cp_async_commit();

  // the lane's states and its part of A (times log2 e)
  float a2[P], h[P];
  const int64_t hs = ((int64_t)b * I + i) * N + q * P;
  if (live) {
    load_vec<P>(a.A + (int64_t)i * N + q * P, a2);
#pragma unroll
    for (int n = 0; n < P; ++n) {
      const float an = kFused ? -expf(a2[n]) : a2[n];
      a2[n] = an * kLog2e;
    }
    if (a.h0 != nullptr) {
      load_vec<P>(a.h0 + hs, h);
    } else {
#pragma unroll
      for (int n = 0; n < P; ++n) h[n] = 0.f;
    }
  } else {
#pragma unroll
    for (int n = 0; n < P; ++n) { a2[n] = 0.f; h[n] = 0.f; }
  }
  const float bias = (kFused && pi < I) ? a.dt_bias[pi] : 0.f;
  const float Dv = (kFused && live) ? a.D[i] : 0.f;
  TO* og = static_cast<TO*>(a.out) + (int64_t)b * S * I + i;

  for (int k = 0; k < n_chunks; ++k) {
    const int slot = k & 1, t0 = k * kChunk;
    const int Lv = min(kChunk, S - t0);             // live steps
    const int Lq = (Lv + Q - 1) / Q * Q;
    const StageT& s = ring[slot];
    cp_async_wait_one();                            // this chunk has landed
    __syncthreads();

    // prologue, once per (t, i): dt (softplus of dt_lin + dt_bias when
    // fused), dt x; 0 past the sequence, so those steps keep the state
    for (int r = tid / kChannels; r < Lq; r += kThreads / kChannels) {
      float dv = 0.f, dx = 0.f;
      if (r < Lv) {
        if constexpr (kFused) {
          const float v = __fadd_rn(to_f32(s.d[r][pc]), bias);
          dv = v > 20.f ? v : log1pf(expf(v));
        } else {
          dv = to_f32(s.d[r][pc]);
        }
        dx = __fmul_rn(dv, to_f32(s.x[r][pc])) * pow2(r + 1);
      }
      dd[r][pc] = make_float2(dv, dx);
    }
    for (int e = tid; e < Lq * 2 * N; e += kThreads) {
      const int r = e / (2 * N), j = e % (2 * N);
      const int n = j % N;
      const bool is_c = j >= N;
      const float v = to_f32(is_c ? s.c[r][n] : s.b[r][n]);
      bc[r][n / P][(is_c ? P : 0) + n % P] = v;
    }
    __syncthreads();

    // Within the chunk the lane carries g = 2^(r+1) h_r after step r, so
    // that g_r = (2 decay) g_(r-1) + 2^(r+1) dt x B: the twice-decay needs
    // no halving (dd holds 2^(r+1) dt x), y_r is the sum over g scaled
    // back by 2^-(r+1), and the state by 2^-Lq at the end.  Powers of 2
    // scale exactly: the same bytes as the unscaled recurrence.
    TO* op = og + (int64_t)(t0 + q) * I;            // this lane's step
#pragma unroll 2
    for (int g = 0; g < Lq; g += Q, op += (int64_t)Q * I) {
      float part[Q];
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        const float2 d2 = dd[g + u][lc];
        float bv[P], cv[P];
        load_vec<P>(&bc[g + u][q][0], bv);
        load_vec<P>(&bc[g + u][q][P], cv);
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < P; ++n) {
          h[n] = fmaf(twice_decay(d2.x, a2[n]), h[n], d2.y * bv[n]);
          acc = fmaf(h[n], cv[n], acc);
        }
        part[u] = acc;
      }
      const int r = g + q;
      const float yv = reduce_scatter<Q>(part, q) * pow2(-(r + 1));
      if (live && r < Lv) {
        TO o;
        if constexpr (kFused) {
          // torch: (y + D * x.f32).to(T) * silu(z) in T, each in f32
          const float u = __fadd_rn(yv, __fmul_rn(Dv, to_f32(s.x[r][lc])));
          const float zv = to_f32(s.z[r][lc]);
          const float sg = zv / (1.f + expf(-zv));
          o = from_f32<TO>(__fmul_rn(to_f32(from_f32<TO>(u)),
                                     to_f32(from_f32<TO>(sg))));
        } else {
          o = yv;
        }
        *op = o;
      }
    }
#pragma unroll
    for (int n = 0; n < P; ++n) h[n] *= pow2(-Lq);
    __syncthreads();                                // the slot is free
    if (k + 2 < n_chunks) stage(slot, t0 + 2 * kChunk);
    cp_async_commit();
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < P; n += 4)
      *reinterpret_cast<float4*>(a.h_out + hs + n) =
          make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
  }
}

template <int N, int P, bool kFused, typename TX, typename TD, typename TBC,
          typename TO>
void launch_typed(const ScanArgs& a, int B, cudaStream_t stream) {
  const dim3 grid((a.I + kChannels - 1) / kChannels, B);
  ssm_scan_kernel<N, P, kFused, TX, TD, TBC, TO>
      <<<grid, kChannels * (N / P), 0, stream>>>(a);
}

using bf16 = __nv_bfloat16;

template <int N, int P>
void launch_bare(const ScanArgs& a, int B, int x_dtype, int bc_dtype,
                 cudaStream_t st) {
  if (x_dtype == 0 && bc_dtype == 0) launch_typed<N, P, false, float, float, float, float>(a, B, st);
  else if (x_dtype == 0) launch_typed<N, P, false, float, float, bf16, float>(a, B, st);
  else if (bc_dtype == 0) launch_typed<N, P, false, bf16, float, float, float>(a, B, st);
  else launch_typed<N, P, false, bf16, float, bf16, float>(a, B, st);
}

template <int N, int P>
void launch_fused(const ScanArgs& a, int B, int dtype, int, cudaStream_t st) {
  if (dtype == 0) launch_typed<N, P, true, float, float, float, float>(a, B, st);
  else launch_typed<N, P, true, bf16, bf16, bf16, bf16>(a, B, st);
}

// the (N, P) pairs built: P in {4, 8}, P <= N
template <bool kFused>
int dispatch(const ScanArgs& a, int B, int N, int P, int d0, int d1,
             cudaStream_t st) {
  auto go = [&](auto launcher) { launcher(a, B, d0, d1, st); return 0; };
  if (N == 4 && P == 4) return kFused ? go(launch_fused<4, 4>) : go(launch_bare<4, 4>);
  if (N == 8 && P == 4) return kFused ? go(launch_fused<8, 4>) : go(launch_bare<8, 4>);
  if (N == 8 && P == 8) return kFused ? go(launch_fused<8, 8>) : go(launch_bare<8, 8>);
  if (N == 16 && P == 4) return kFused ? go(launch_fused<16, 4>) : go(launch_bare<16, 4>);
  if (N == 16 && P == 8) return kFused ? go(launch_fused<16, 8>) : go(launch_bare<16, 8>);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

}  // namespace

// One record of int64s a call (the binding packs it in one buffer, so a
// call crosses from Python as one pointer).  Device pointers as integers
// (0: absent); dtype codes 0 float32, 1 bfloat16; strides in elements.
struct LaunchArgs {
  int64_t x, dt, z, dt_bias, Bc, Cc, A, D, h0, out, h_out;
  int64_t dtype, bc_dtype, B, S, I, N, P;
  int64_t x_sb, x_st, d_sb, d_st, z_sb, z_st, b_sb, b_st, c_sb, c_st;
  int64_t stream;
};

namespace {

template <typename T>
T ptr(int64_t v) { return reinterpret_cast<T>(static_cast<intptr_t>(v)); }

template <bool kFused>
int launch(const LaunchArgs& c) {
  const float* A = ptr<const float*>(c.A);
  const float* h0 = ptr<const float*>(c.h0);
  float* h_out = ptr<float*>(c.h_out);
  if (misaligned(A) || misaligned(h0) || misaligned(h_out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const ScanArgs a{ptr<const void*>(c.x), ptr<const void*>(c.dt),
                   ptr<const void*>(c.z), ptr<const void*>(c.Bc),
                   ptr<const void*>(c.Cc), A, ptr<const float*>(c.dt_bias),
                   ptr<const float*>(c.D), h0, ptr<void*>(c.out), h_out,
                   static_cast<int>(c.S), static_cast<int>(c.I),
                   c.x_sb, c.x_st, c.d_sb, c.d_st, c.z_sb, c.z_st,
                   c.b_sb, c.b_st, c.c_sb, c.c_st};
  const int err = dispatch<kFused>(
      a, static_cast<int>(c.B), static_cast<int>(c.N), static_cast<int>(c.P),
      static_cast<int>(c.dtype), static_cast<int>(c.bc_dtype),
      ptr<cudaStream_t>(c.stream));
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bare scan.  x, dt (B, S, I), Bc, Cc (B, S, N): unit stride over the
// last axis; dt f32; x (dtype) and Bc, Cc (bc_dtype) f32 or bf16.  out =
// y (B, S, I) f32, contiguous.  A (I, N) f32 and h0, h_out (B, I, N) f32,
// contiguous and 16-byte aligned; h0 may be 0 (zeros) and may equal
// h_out.  z, dt_bias, D unused.  N is 4, 8 or 16 and P (states a lane)
// 4 or 8, P <= N.
extern "C" int ssm_scan_launch(const LaunchArgs* a) { return launch<false>(*a); }

// The mixer's scan: x, dt (= dt_lin), z (B, S, I), Bc, Cc (B, S, N), all
// of one dtype, unit stride over the last axis; dt_bias, D (I,) f32; A =
// A_log (I, N) f32, h0, h_out as above; out (B, S, I) in the dtype,
// contiguous.
extern "C" int mamba_scan_launch(const LaunchArgs* a) { return launch<true>(*a); }
