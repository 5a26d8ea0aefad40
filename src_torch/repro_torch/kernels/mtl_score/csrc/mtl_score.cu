// Fused factored-model scoring for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mtl_score/kernel.py:57 mtl_score_fused
//   (pallas_call :86, body _kernel :40)
// and computes, for every request b of a wave,
//
//   score[b] = sum_r (x_b . U)[r] * C[clamp(id_b)][r] * S[clamp(id_b)]
//
// with U (p, r) the shared basis, C (m, r) the code table (f32, int8 or
// fp8 e4m3), S (m, 1) its per-code f32 scales, ids clamped to [0, m-1].
// X and U may be f32 or bf16; everything accumulates in f32.  The
// projection x_b . U is computed here, in the kernel's own body.
//
// Bound: bytes.  The least traffic is
//   B*p*sizeof(x) + p*r*sizeof(u) + 8*B (ids in, scores out)
//   + (distinct ids) * (r*sizeof(code) + 4) (code rows and their scales)
// against 2*B*p*r flops: about r/2 flops per byte of X, far below the
// card's ridge, so the kernel streams X once and does nothing else with
// memory.  At the serving point (p=2048, r=4, B=64..256) one wave is
// 0.5-2 MB of X, well under a microsecond of HBM time, so what bounds a
// call there is the launch and one or two memory latencies; at B=4096
// (32 MB of f32 X) it is the bytes.
//
// Design: keep many 16-byte loads of X in flight, issue U's loads with
// them, and read each row of U once for several rows of X.
//  * A row's p is cut over warps_per_row warps of one CTA, and a warp
//    takes rows_per_warp (RW = 1 or 4) rows at once (kernel.plan: RW = 4
//    while the CTAs still cover the SMs, as at B=4096; else 1, and the
//    fewest warps a row that keep the CTAs covering the SMs, as at
//    B=256); a CTA of kWarps warps holds kWarps / warps_per_row * RW
//    rows.
//  * Lane g of a row's warps_per_row * 32 (g = w * 32 + lane) takes the
//    16-byte chunks g, g + n_lanes, ... of its rows when every row is
//    16-byte aligned (X aligned, p * sizeof(x) a multiple of 16), else
//    the elements g, g + n_lanes, ... one at a time, as it does for the
//    tail past the last whole chunk.  It issues kBatch loads of X
//    (kBatch / RW chunks of each of its RW rows) before it uses any, and
//    its loads of U rows for those chunks go out with them.
//  * U row j (r values) is read as one vector when r is the rank bucket
//    RB (4 or 8) and U is aligned for it (a float4 at r=4 f32, two at
//    r=8), else one element at a time, once for the RW rows; U (32 KB at
//    p=2048, r=4 f32) stays in L1/L2 across the rows.
//  * RW x RB accumulators in registers (r <= RB <= kMaxR), a warp's lanes summed by
//    a shuffle tree (16, 8, 4, 2, 1), the warps of a row in shared memory
//    in warp order: no atomics, a relaunch is bitwise the same.
//  * lane k < r of the row's first warp gathers code element k of each
//    of its clamped rows and decodes it times the row's scale before it
//    loads any X (the id -> code chain off the critical path), and at the
//    end multiplies it by projection k; a shuffle over the first kMaxR
//    lanes sums the r products and lane 0 stores.
//
// C interface: mtl_score_launch() launches on the given stream, does not
// synchronise and allocates nothing; it returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxR = 8;     // the repo serves r = 3..8
constexpr int kWarps = 8;    // a CTA's warps
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 8;    // 16-byte loads of X a lane issues before use
constexpr int kMaxRowsPerWarp = 4;
static_assert(kMaxR <= 8, "the final shuffle sums lanes 0..7");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 16-byte loads of X: kVec elements decoded to f32.
template <typename TX> struct XVec;

template <> struct XVec<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void cvt(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
};

template <> struct XVec<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void cvt(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // little endian: element 2i is the low half
      f[2 * i] = bf16_lo(w[i]);
      f[2 * i + 1] = bf16_hi(w[i]);
    }
  }
};

// U row j as RB f32 values (0 past r): one vector load when `vec` (r ==
// RB, U aligned for it), else r element loads.
template <typename TU, int RB> struct URow;

template <int RB> struct URow<float, RB> {
  __device__ __forceinline__ static void load(const float* __restrict__ U,
                                              size_t j, int r, bool vec,
                                              float* u) {
    if (vec) {
      const float4* v = reinterpret_cast<const float4*>(U + j * RB);
#pragma unroll
      for (int h = 0; h < RB / 4; ++h) {
        const float4 x = __ldg(v + h);
        u[4 * h] = x.x; u[4 * h + 1] = x.y; u[4 * h + 2] = x.z; u[4 * h + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < RB; ++k) u[k] = k < r ? __ldg(U + j * r + k) : 0.f;
    }
  }
};

template <int RB> struct URow<__nv_bfloat16, RB> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* __restrict__ U,
                                              size_t j, int r, bool vec,
                                              float* u) {
    if (vec) {
      if (RB == 8) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(U + j * RB));
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) { u[2 * i] = bf16_lo(w[i]); u[2 * i + 1] = bf16_hi(w[i]); }
      } else {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(U + j * RB));
        u[0] = bf16_lo(x.x); u[1] = bf16_hi(x.x);
        u[2] = bf16_lo(x.y); u[3] = bf16_hi(x.y);
      }
    } else {
#pragma unroll
      for (int k = 0; k < RB; ++k) u[k] = k < r ? to_f32(U[j * r + k]) : 0.f;
    }
  }
};

// code element k of row id, decoded, times the row's scale
__device__ __forceinline__ float code_at(const void* C, int c_dtype,
                                         const float* S, int id, int r,
                                         int k) {
  const size_t at = static_cast<size_t>(id) * r + k;
  float c;
  switch (c_dtype) {
    case 1: c = to_f32(static_cast<const int8_t*>(C)[at]); break;
    case 2: c = to_f32(static_cast<const __nv_fp8_e4m3*>(C)[at]); break;
    default: c = static_cast<const float*>(C)[at];
  }
  return c * S[id];
}

struct Shape {
  int B, p, m, r, c_dtype;
  int warps_per_row;
  bool vec_x, vec_u;
};

template <typename TX, typename TU, int RB, int RW>
__global__ void __launch_bounds__(kThreads)
mtl_score_kernel(const TU* __restrict__ U, const void* __restrict__ C,
                 const float* __restrict__ S, const int32_t* __restrict__ ids,
                 const TX* __restrict__ X, float* __restrict__ out,
                 const Shape sh) {
  constexpr int V = XVec<TX>::kVec;
  constexpr int NB = kBatch / RW;            // chunks of each row a batch
  __shared__ float warp_s[kWarps][RW][kMaxR];   // each warp's r sums
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int spr = sh.warps_per_row;
  const int row0 = (static_cast<int>(blockIdx.x) * (kWarps / spr) + warp / spr)
                   * RW;
  const int n_lanes = spr * 32;                       // lanes over a row
  const int g = (warp % spr) * 32 + lane;
  const int r = sh.r;
  const bool lead = warp % spr == 0;       // the row's first warp finishes it
  const size_t p = static_cast<size_t>(sh.p);

  // the code elements and scales this lane multiplies at the end, read
  // now so that their latency hides behind X's
  float code[RW];
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    code[q] = 0.f;
    if (lead && lane < r && row0 + q < sh.B) {
      int id = ids[row0 + q];
      id = id < 0 ? 0 : (id >= sh.m ? sh.m - 1 : id);   // the reference kernel's clamp
      code[q] = code_at(C, sh.c_dtype, S, id, r, lane);
    }
  }

  float acc[RW][RB];
#pragma unroll
  for (int q = 0; q < RW; ++q)
#pragma unroll
    for (int k = 0; k < RB; ++k) acc[q][k] = 0.f;

  if (row0 < sh.B) {                         // warp-uniform
    const TX* __restrict__ x = X + static_cast<size_t>(row0) * p;
    const int live = min(RW, sh.B - row0);   // rows of this warp in X
    size_t vec_end = 0;
    if (sh.vec_x) {
      const size_t n_vec = p / V;
      vec_end = n_vec * V;
      const uint4* xv = reinterpret_cast<const uint4*>(x);
      const size_t row_chunks = n_vec;
      for (size_t c0 = g; c0 < n_vec; c0 += static_cast<size_t>(NB) * n_lanes) {
        uint4 raw[NB][RW];
#pragma unroll
        for (int i = 0; i < NB; ++i) {       // every load before any use
          const size_t c = c0 + static_cast<size_t>(i) * n_lanes;
#pragma unroll
          for (int q = 0; q < RW; ++q)
            raw[i][q] = c < n_vec && q < live
                            ? __ldcs(xv + q * row_chunks + c)
                            : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const size_t c = c0 + static_cast<size_t>(i) * n_lanes;
          if (c < n_vec) {
            float xf[RW][V];
#pragma unroll
            for (int q = 0; q < RW; ++q) XVec<TX>::cvt(raw[i][q], xf[q]);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              float u[RB];
              URow<TU, RB>::load(U, c * V + e, r, sh.vec_u, u);
#pragma unroll
              for (int q = 0; q < RW; ++q)
#pragma unroll
                for (int k = 0; k < RB; ++k)
                  acc[q][k] = fmaf(xf[q][e], u[k], acc[q][k]);
            }
          }
        }
      }
    }
    for (size_t j = vec_end + g; j < p; j += n_lanes) {
      float u[RB];
      URow<TU, RB>::load(U, j, r, sh.vec_u, u);
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const float xe = q < live ? to_f32(x[q * p + j]) : 0.f;
#pragma unroll
        for (int k = 0; k < RB; ++k) acc[q][k] = fmaf(xe, u[k], acc[q][k]);
      }
    }
  }

  // the warp's sums: every lane ends with them
#pragma unroll
  for (int q = 0; q < RW; ++q) {
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      if (k < r) {                            // r is uniform across the warp
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[q][k] += __shfl_xor_sync(0xffffffffu, acc[q][k], off);
      }
    }
    if (lane < r) {
      float z = 0.f;                          // acc[q][lane] without local memory
#pragma unroll
      for (int k = 0; k < RB; ++k)
        if (k == lane) z = acc[q][k];
      warp_s[warp][q][lane] = z;
    }
  }
  __syncthreads();
  if (!lead || row0 >= sh.B) return;         // the whole warp leaves together

  // each row's warps in warp order, then the r-term dot
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    float part = 0.f;
    if (lane < r) {
      float z = warp_s[warp][q][lane];
      for (int w = 1; w < spr; ++w) z += warp_s[warp + w][q][lane];
      part = z * code[q];
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)    // lanes >= r hold 0
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0 && row0 + q < sh.B) out[row0 + q] = part;
  }
}

template <typename TX, typename TU, int RB, int RW>
cudaError_t launch(const void* U, const void* C, const float* S,
                   const int32_t* ids, const void* X, float* out,
                   const Shape& sh, cudaStream_t stream) {
  const int rows_per_cta = kWarps / sh.warps_per_row * RW;
  const int blocks = (sh.B + rows_per_cta - 1) / rows_per_cta;
  mtl_score_kernel<TX, TU, RB, RW><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TU*>(U), C, S, ids, static_cast<const TX*>(X), out,
      sh);
  return cudaGetLastError();
}

template <typename TX, typename TU>
cudaError_t by_rank(const void* U, const void* C, const float* S,
                    const int32_t* ids, const void* X, float* out, Shape sh,
                    int rows_per_warp, cudaStream_t stream) {
  const int rb = sh.r <= 4 ? 4 : 8;
  const uintptr_t align = static_cast<uintptr_t>(rb) * sizeof(TU) < 16
                              ? static_cast<uintptr_t>(rb) * sizeof(TU) : 16;
  sh.vec_u = sh.r == rb && (reinterpret_cast<uintptr_t>(U) % align) == 0;
  sh.vec_x = (reinterpret_cast<uintptr_t>(X) & 15u) == 0 &&
             (static_cast<size_t>(sh.p) * sizeof(TX)) % 16 == 0;
  if (rows_per_warp == kMaxRowsPerWarp)
    return rb == 4 ? launch<TX, TU, 4, kMaxRowsPerWarp>(U, C, S, ids, X, out, sh, stream)
                   : launch<TX, TU, 8, kMaxRowsPerWarp>(U, C, S, ids, X, out, sh, stream);
  return rb == 4 ? launch<TX, TU, 4, 1>(U, C, S, ids, X, out, sh, stream)
                 : launch<TX, TU, 8, 1>(U, C, S, ids, X, out, sh, stream);
}

template <typename TX>
cudaError_t by_basis(int u_dtype, const void* U, const void* C,
                     const float* S, const int32_t* ids, const void* X,
                     float* out, const Shape& sh, int rows_per_warp,
                     cudaStream_t stream) {
  switch (u_dtype) {
    case 0: return by_rank<TX, float>(U, C, S, ids, X, out, sh, rows_per_warp, stream);
    case 1: return by_rank<TX, __nv_bfloat16>(U, C, S, ids, X, out, sh, rows_per_warp, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: X and U 0 = f32, 1 = bf16; C 0 = f32, 1 = int8, 2 = fp8 e4m3.
// All arrays are dense row-major: U (p, r), C (m, r), S (m, 1), ids (B,),
// X (B, p), out (B,).  warps_per_row 1, 2, 4 or 8; rows_per_warp 1 or 4
// (a CTA holds 8 / warps_per_row * rows_per_warp rows).
extern "C" int mtl_score_launch(const void* U, int u_dtype, const void* C,
                                int c_dtype, const void* S, const void* ids,
                                const void* X, int x_dtype, void* out,
                                int B, int p, int m, int r, int warps_per_row,
                                int rows_per_warp, void* stream) {
  const bool spr_ok = warps_per_row == 1 || warps_per_row == 2 ||
                      warps_per_row == 4 || warps_per_row == kWarps;
  const bool rw_ok = rows_per_warp == 1 || rows_per_warp == kMaxRowsPerWarp;
  if (B < 1 || p < 1 || m < 1 || r < 1 || r > kMaxR || !spr_ok || !rw_ok ||
      c_dtype < 0 || c_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{B, p, m, r, c_dtype, warps_per_row, false, false};
  const float* s = static_cast<const float*>(S);
  const int32_t* id = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_dtype) {
    case 0: err = by_basis<float>(u_dtype, U, C, s, id, X, o, sh, rows_per_warp, st); break;
    case 1: err = by_basis<__nv_bfloat16>(u_dtype, U, C, s, id, X, o, sh, rows_per_warp, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
