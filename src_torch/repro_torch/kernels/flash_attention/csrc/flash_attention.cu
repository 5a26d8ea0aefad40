// Flash attention with explicit positions, for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:85 flash_attention_bhsd
// (pallas_call :107, body _kernel :31), reached through
// repro.models.attention.sdpa.  Unlike that kernel, which assumes the
// positions 0..S-1, this one takes each query's and each key's position
// (fresh keys at contiguous positions, or a ring buffer of wrapped slots
// with empty slots at a negative position).  It computes the reference's
// _sdpa_naive with _mask_bias: s = (q . k) * scale in f32, then
// softcap * tanh(s / softcap) when a softcap is set; key j counts for
// query i when k_pos[j] >= 0, k_pos[j] <= q_pos[i] (causal) and
// k_pos[j] > q_pos[i] - window (window > 0); softmax over the keys that
// count, times v in f32, cast to the input type.  A row where no key
// counts is 0.
//
// Layout: q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), out like q, all
// contiguous; H = Hkv * group and query head h = kvh * group + g, so the
// group heads of one query are contiguous.  q_pos (B, Sq), k_pos (B, Sk)
// int32.
//
// Design (simple and deterministic; no tensor cores, no atomics).  One
// CTA of 8 warps takes one (batch, KV head) and 64 query rows: bq = 64 /
// group query positions times the group heads that share the KV head,
// so each K/V tile is read once for the whole group.  Warp w owns rows
// 8w..8w+7; Q lives in shared memory as f32.  Each thread issues all its
// loads of a tile before it stores any to shared memory, so a tile costs
// one memory latency.  Keys stream in tiles of 32, one key per lane: the
// tile's K and V are staged in shared memory as f32 (K rows padded by 4
// floats so the lanes' 16-byte reads of 32 different keys hit distinct
// banks); each lane computes the scores of its key against the warp's 8
// rows, the warp reduces the row max and sum with shuffles (fixed
// butterfly order), and the online softmax state (m, l) and the f32
// accumulator acc (8 rows x hd/32 columns per lane) stay in registers;
// P . V broadcasts each key's probability from its lane.  Before a tile
// is loaded the CTA tests its positions against its rows
// (__syncthreads_or) and skips a tile in which no key counts for any
// row: that is the causal and window skip, read from the positions
// themselves.
//
// Which calls come here (kernel.route): f32 calls of more than 8 query
// rows (Sq * group), and bf16 calls of 9 to 63 rows.  bf16 prefill of 64
// rows or more runs on the tensor cores (csrc/flash_attention_wgmma.cu);
// every call of at most 8 rows, a decode step, runs on the decode kernel
// (csrc/flash_decode.cu).
//
// What bounds it: at the f32 prefill (B=4, S=5120, gemma2-2b) it does
// ~1.1e13 f32 operations on CUDA cores (67 TFLOP/s peak), so operations;
// the design's limit is the shared-memory and shuffle traffic beside the
// FMAs, and one CTA per SM at hd=256 (131 KB of shared memory).  When
// the query CTAs alone leave most SMs idle (few query blocks against
// many keys), the keys are split over n_split CTAs, each writing its
// unnormalised (acc, m, l) to a scratch buffer, and a second kernel
// combines the splits in a fixed order, so a relaunch is bitwise the
// same.
//
// The C entry point returns cudaGetLastError() after its launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int RPW = 8;                        // query rows a warp
constexpr int kRowsPerCta = kWarps * RPW;
constexpr int kTileK = 32;                    // keys per tile, one per lane
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* k_pos;
  void* out;
  float* part;       // n_split > 1: [n_split][rows_total][hd + 2]
  int B, Sq, Sk, H, Hkv, group, bq;  // bq = rows per CTA / group
  int causal, window;
  float softcap, scale;
  int n_split, tiles_per_split;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// element offset of row r (query q0 + r / group, head kvh*group + r % group)
__device__ __forceinline__ long long row_offset(const Params& p, int b,
                                                int kvh, int q0, int r,
                                                int hd) {
  const int qi = q0 + r / p.group;
  const int h = kvh * p.group + r % p.group;
  return ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * hd;
}

template <int HD>
constexpr int smem_floats() {
  return kWarps * RPW * HD + kTileK * (HD + 4) + kTileK * HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Params p) {
  constexpr int kRows = kWarps * RPW;  // query rows per CTA
  constexpr int DL = HD / 32;          // output columns per lane
  constexpr int KS = HD + 4;           // padded K row stride
  constexpr int H4 = HD / 4;
  constexpr int kQLoads = (kRows * H4 + kThreads - 1) / kThreads;
  constexpr int kKLoads = kTileK * H4 / kThreads;  // HD >= 32: at least 1
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRows][HD]
  float* k_s = q_s + kRows * HD;                 // [kTileK][KS]
  float* v_s = k_s + kTileK * KS;                // [kTileK][HD]

  const int qblock = blockIdx.x;
  const int bh = blockIdx.y;
  const int split = blockIdx.z;
  const int b = bh / p.Hkv;
  const int kvh = bh % p.Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qblock * p.bq;
  const int n_rows = min(p.bq, p.Sq - q0) * p.group;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  // Q rows as f32, all loads issued before the stores; rows past n_rows
  // are zero
  {
    float4 x[kQLoads];
#pragma unroll
    for (int u = 0; u < kQLoads; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / H4, c = (i % H4) * 4;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < kRows * H4 && r < n_rows)
        x[u] = load4(q + row_offset(p, b, kvh, q0, r, HD) + c);
    }
#pragma unroll
    for (int u = 0; u < kQLoads; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < kRows * H4)
        *reinterpret_cast<float4*>(q_s + (i / H4) * HD + (i % H4) * 4) = x[u];
    }
  }

  const int row0 = warp * RPW;
  const bool warp_live = row0 < n_rows;
  int qp[RPW];
  bool row_ok[RPW];
  float m[RPW], l[RPW], acc[RPW][DL];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = row0 + j;
    row_ok[j] = r < n_rows;
    qp[j] = row_ok[j] ? p.q_pos[b * p.Sq + q0 + r / p.group] : 0;
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[j][d] = 0.f;
  }

  const int n_tiles = (p.Sk + kTileK - 1) / kTileK;
  const int t_begin = split * p.tiles_per_split;
  const int t_end = min(n_tiles, t_begin + p.tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int key = t * kTileK + lane;
    const int kp = key < p.Sk ? p.k_pos[b * p.Sk + key] : -1;
    bool ok[RPW];
    bool any = false;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      bool o = row_ok[j] && kp >= 0;
      if (p.causal) o = o && kp <= qp[j];
      if (p.window > 0) o = o && kp > qp[j] - p.window;
      ok[j] = o;
      any = any || o;
    }
    // also the barrier that retires the previous tile's K/V
    if (!__syncthreads_or(any)) continue;

    {
      float4 kx[kKLoads], vx[kKLoads];
#pragma unroll
      for (int u = 0; u < kKLoads; ++u) {
        const int i = threadIdx.x + u * kThreads;
        const int kk = t * kTileK + i / H4;
        kx[u] = vx[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kk < p.Sk) {
          const long long off =
              ((static_cast<long long>(b) * p.Sk + kk) * p.Hkv + kvh) * HD +
              (i % H4) * 4;
          kx[u] = load4(k + off);
          vx[u] = load4(v + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kKLoads; ++u) {
        const int i = threadIdx.x + u * kThreads;
        const int c = i / H4, d = (i % H4) * 4;
        *reinterpret_cast<float4*>(k_s + c * KS + d) = kx[u];
        *reinterpret_cast<float4*>(v_s + c * HD + d) = vx[u];
      }
    }
    __syncthreads();
    if (!warp_live) continue;

    // scores of this lane's key against the warp's rows
    float s[RPW];
#pragma unroll
    for (int j = 0; j < RPW; ++j) s[j] = 0.f;
    const float* krow = k_s + lane * KS;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kx = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const float4 qx =
            *reinterpret_cast<const float4*>(q_s + (row0 + j) * HD + d);
        s[j] = fmaf(qx.x, kx.x, s[j]);
        s[j] = fmaf(qx.y, kx.y, s[j]);
        s[j] = fmaf(qx.z, kx.z, s[j]);
        s[j] = fmaf(qx.w, kx.w, s[j]);
      }
    }

    // online softmax; s[j] becomes this lane's probability for row j
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      float x = s[j] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      x = ok[j] ? x : -INFINITY;
      const float m_new = fmaxf(m[j], warp_max(x));
      float alpha = 1.f, pr = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[j] - m_new);  // exp(-inf) = 0 on the first live tile
        pr = ok[j] ? expf(x - m_new) : 0.f;
      }
      l[j] = l[j] * alpha + warp_sum(pr);
      m[j] = m_new;
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[j][d] *= alpha;
      s[j] = pr;
    }

    // acc += P . V: key c's probability comes from lane c
#pragma unroll 2
    for (int c = 0; c < kTileK; ++c) {
      float vx[DL];
#pragma unroll
      for (int d = 0; d < DL; ++d) vx[d] = v_s[c * HD + lane + 32 * d];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const float pc = __shfl_sync(kFull, s[j], c);
#pragma unroll
        for (int d = 0; d < DL; ++d) acc[j][d] = fmaf(pc, vx[d], acc[j][d]);
      }
    }
  }

  if (!warp_live) return;
  if (p.n_split == 1) {
    T* out = static_cast<T*>(p.out);
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      if (!row_ok[j]) continue;
      T* o = out + row_offset(p, b, kvh, q0, row0 + j, HD);
#pragma unroll
      for (int d = 0; d < DL; ++d)
        store1(o + lane + 32 * d, l[j] > 0.f ? acc[j][d] / l[j] : 0.f);
    }
    return;
  }
  const long long rows_total =
      static_cast<long long>(gridDim.x) * gridDim.y * kRows;
  const long long row_base =
      (static_cast<long long>(bh) * gridDim.x + qblock) * kRows;
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    if (!row_ok[j]) continue;
    float* dst = p.part + (split * rows_total + row_base + row0 + j) * (HD + 2);
#pragma unroll
    for (int d = 0; d < DL; ++d) dst[lane + 32 * d] = acc[j][d];
    if (lane == 0) {
      dst[HD] = m[j];
      dst[HD + 1] = l[j];
    }
  }
}

// Second pass of a split launch: out = sum_z acc_z e^(m_z - M) /
// sum_z l_z e^(m_z - M) over the splits z in order, M = max_z m_z.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_combine(const Params p) {
  constexpr int kRows = kWarps * RPW;
  constexpr int DL = HD / 32;
  const int qblock = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.Hkv;
  const int kvh = bh % p.Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qblock * p.bq;
  const int n_rows = min(p.bq, p.Sq - q0) * p.group;
  const long long rows_total =
      static_cast<long long>(gridDim.x) * gridDim.y * kRows;
  const long long row_base =
      (static_cast<long long>(bh) * gridDim.x + qblock) * kRows;
  T* out = static_cast<T*>(p.out);
  for (int r = warp; r < n_rows; r += kWarps) {
    const float* src = p.part + (row_base + r) * (HD + 2);
    const long long stride = rows_total * (HD + 2);
    float M = -INFINITY;
    for (int z = 0; z < p.n_split; ++z) M = fmaxf(M, src[z * stride + HD]);
    float L = 0.f, o[DL];
#pragma unroll
    for (int d = 0; d < DL; ++d) o[d] = 0.f;
    if (M != -INFINITY) {
      for (int z = 0; z < p.n_split; ++z) {
        const float* part = src + z * stride;
        const float w = expf(part[HD] - M);
        L = fmaf(part[HD + 1], w, L);
#pragma unroll
        for (int d = 0; d < DL; ++d) o[d] = fmaf(part[lane + 32 * d], w, o[d]);
      }
    }
    T* dst = out + row_offset(p, b, kvh, q0, r, HD);
#pragma unroll
    for (int d = 0; d < DL; ++d)
      store1(dst + lane + 32 * d, L > 0.f ? o[d] / L : 0.f);
  }
}

template <typename T, int HD>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  const int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  // the opt-in holds per device, so it is set on every launch (cheap)
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.B * p.Hkv, p.n_split);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(p);
  if (p.n_split > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_attention_combine<T, HD>
        <<<dim3(grid.x, grid.y), kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_typed<T, 64>(p, stream);
    case 128: return launch_typed<T, 128>(p, stream);
    case 256: return launch_typed<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  rows_per_cta: 64, at least the group.
// window <= 0: no window; softcap <= 0: none.
// n_split > 1 needs part: n_split * ceil(Sq/bq) * B*Hkv * rows_per_cta *
// (hd + 2) floats, bq = rows_per_cta / (H / Hkv).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const int* q_pos, const int* k_pos, void* out,
                           float* part, int dtype, int B, int Sq, int Sk,
                           int H, int Hkv, int hd, int rows_per_cta,
                           int causal, int window, float softcap,
                           float scale, int n_split, int tiles_per_split,
                           cudaStream_t stream) {
  if (Hkv <= 0 || H % Hkv != 0 ||
      rows_per_cta != kRowsPerCta ||
      H / Hkv > rows_per_cta || n_split < 1 || tiles_per_split < 1 ||
      (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_pos = q_pos;
  p.k_pos = k_pos;
  p.out = out;
  p.part = part;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.Hkv = Hkv;
  p.group = H / Hkv;
  p.bq = rows_per_cta / p.group;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  p.n_split = n_split;
  p.tiles_per_split = tiles_per_split;
  cudaError_t e =
      dtype == 0   ? launch_hd<float>(p, hd, stream)
      : dtype == 1 ? launch_hd<__nv_bfloat16>(p, hd, stream)
                   : cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"
