// Fused factored-model scoring for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mtl_score/kernel.py :: mtl_score_fused  (body _kernel)
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
// card's ~20 f32 flops per byte, so the kernel streams X once and does
// nothing else with memory.  At the serving point (p=2048, r=4, B=64..256)
// one wave is 0.5-2 MB of X, well under a microsecond of HBM time, so
// what bounds a wave there is launch latency, not the kernel body.
//
// Design (a simple kernel that is right, first):
//  * one warp per request row; a block holds kWarps rows;
//  * lanes stride over p with 16-byte loads of X when the row is 16-byte
//    aligned, scalar loads for the tail (and for unaligned rows);
//  * U (32 KB at p=2048, r=4 in f32) is read through the read-only path
//    and stays in L1/L2 across the rows of a wave;
//  * r <= kMaxR accumulators live in registers and are reduced with warp
//    shuffles, so every lane ends with the whole projection;
//  * lane k < r gathers code element k of the clamped row, decodes it,
//    multiplies by the row's scale and by projection k; a shuffle over
//    the first kMaxR lanes sums the r products and lane 0 stores.
//
// C interface: mtl_score_launch() launches on the given stream, does not
// synchronise and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kMaxR = 8;     // the repo serves r = 3..8
constexpr int kWarps = 4;    // request rows per block
static_assert(kMaxR <= 8, "the final shuffle sums lanes 0..7");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

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

template <typename TU>
__device__ __forceinline__ void accumulate(float xe, const TU* __restrict__ u,
                                           int r, float* acc) {
#pragma unroll
  for (int k = 0; k < kMaxR; ++k)
    if (k < r) acc[k] = fmaf(xe, to_f32(u[k]), acc[k]);
}

template <typename TX, typename TU, typename TC>
__global__ void __launch_bounds__(kWarps * 32)
mtl_score_kernel(const TU* __restrict__ U, const TC* __restrict__ C,
                 const float* __restrict__ S, const int32_t* __restrict__ ids,
                 const TX* __restrict__ X, float* __restrict__ out,
                 int B, int p, int m, int r) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;                       // the whole warp leaves together
  const TX* __restrict__ x = X + static_cast<size_t>(row) * p;

  float acc[kMaxR];
#pragma unroll
  for (int k = 0; k < kMaxR; ++k) acc[k] = 0.f;

  constexpr int V = XVec<TX>::kVec;
  int vec_end = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15u) == 0) {
    vec_end = (p / V) * V;
    for (int j0 = lane * V; j0 < vec_end; j0 += 32 * V) {
      float xv[V];
      XVec<TX>::load(x + j0, xv);
#pragma unroll
      for (int e = 0; e < V; ++e)
        accumulate(xv[e], U + static_cast<size_t>(j0 + e) * r, r, acc);
    }
  }
  for (int j = vec_end + lane; j < p; j += 32)
    accumulate(to_f32(x[j]), U + static_cast<size_t>(j) * r, r, acc);

  // every lane ends with the full projection x . U[:, k]
#pragma unroll
  for (int k = 0; k < kMaxR; ++k) {
    if (k < r) {                              // r is uniform across the warp
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
  }

  int id = ids[row];
  id = id < 0 ? 0 : (id >= m ? m - 1 : id);   // the reference kernel's clamp
  float part = 0.f;
  if (lane < r) {
    float z = 0.f;                            // acc[lane] without local memory
#pragma unroll
    for (int k = 0; k < kMaxR; ++k)
      if (k == lane) z = acc[k];
    const float c = to_f32(C[static_cast<size_t>(id) * r + lane]) * S[id];
    part = z * c;
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)      // lanes >= r hold 0
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) out[row] = part;
}

template <typename TX, typename TU, typename TC>
cudaError_t launch(const void* U, const void* C, const float* S,
                   const int32_t* ids, const void* X, float* out,
                   int B, int p, int m, int r, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  mtl_score_kernel<TX, TU, TC><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const TU*>(U), static_cast<const TC*>(C), S, ids,
      static_cast<const TX*>(X), out, B, p, m, r);
  return cudaGetLastError();
}

template <typename TX, typename TU>
cudaError_t by_code(int c_dtype, const void* U, const void* C, const float* S,
                    const int32_t* ids, const void* X, float* out,
                    int B, int p, int m, int r, cudaStream_t stream) {
  switch (c_dtype) {
    case 0: return launch<TX, TU, float>(U, C, S, ids, X, out, B, p, m, r, stream);
    case 1: return launch<TX, TU, int8_t>(U, C, S, ids, X, out, B, p, m, r, stream);
    case 2: return launch<TX, TU, __nv_fp8_e4m3>(U, C, S, ids, X, out, B, p, m, r, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t by_basis(int u_dtype, int c_dtype, const void* U, const void* C,
                     const float* S, const int32_t* ids, const void* X,
                     float* out, int B, int p, int m, int r,
                     cudaStream_t stream) {
  switch (u_dtype) {
    case 0: return by_code<TX, float>(c_dtype, U, C, S, ids, X, out, B, p, m, r, stream);
    case 1: return by_code<TX, __nv_bfloat16>(c_dtype, U, C, S, ids, X, out, B, p, m, r, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: X and U 0 = f32, 1 = bf16; C 0 = f32, 1 = int8, 2 = fp8 e4m3.
// All arrays are dense row-major: U (p, r), C (m, r), S (m, 1), ids (B,),
// X (B, p), out (B,).
extern "C" int mtl_score_launch(const void* U, int u_dtype, const void* C,
                                int c_dtype, const void* S, const void* ids,
                                const void* X, int x_dtype, void* out,
                                int B, int p, int m, int r, void* stream) {
  if (B < 1 || p < 1 || m < 1 || r < 1 || r > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(S);
  const int32_t* id = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_dtype) {
    case 0: err = by_basis<float>(u_dtype, c_dtype, U, C, s, id, X, o, B, p, m, r, st); break;
    case 1: err = by_basis<__nv_bfloat16>(u_dtype, c_dtype, U, C, s, id, X, o, B, p, m, r, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
