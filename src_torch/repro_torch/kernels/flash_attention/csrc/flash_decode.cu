// Flash attention for decode, with explicit positions, for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:85 flash_attention_bhsd
// (pallas_call :107, body _kernel :31) for every call whose Sq * group
// query rows fit in 8: a decode step (one query, or a few, against the
// KV cache).  It computes what csrc/flash_attention.cu computes, the
// reference's _sdpa_naive with _mask_bias: s = (q . k) * scale in f32,
// then softcap * tanh(s / softcap) when a softcap is set; key j counts
// for query i when k_pos[j] >= 0, k_pos[j] <= q_pos[i] (causal) and
// k_pos[j] > q_pos[i] - window (window > 0); softmax over the keys that
// count, times v in f32, cast to the input type.  A row where no key
// counts is 0.  Ring slots hold wrapped positions; an empty slot holds a
// negative one.
//
// Layout: q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), out like q, all
// contiguous; H = Hkv * group and row r of a (batch, KV head) is query
// r / group of head kvh * group + r % group.  q_pos (B, Sq), k_pos
// (B, Sk) int32.
//
// What bounds it: the bytes of K and V.  Each cached byte is read once
// and takes about one FMA (q . k, then p . v), far below the card's
// ridge, so the design aims at moving K and V at the memory's rate:
//
//  * grid (n_split, B * Hkv): one CTA of 8 warps per (batch, KV head,
//    run of tiles_per_split key tiles), n_split chosen by kernel.plan so
//    that about one CTA sits on every SM (two fit, ~107 KB of shared
//    memory each, but one a SM read faster on the card);
//  * a tile is kTileBytes of K and as many of V (TK = kTileBytes /
//    (hd * sizeof(T)) keys), copied by cp.async into a ring of kStages
//    stages in the cache's own dtype, two tiles in flight while the
//    warps work on a third;
//  * keys go over the warps (warp w takes keys w*KPW..w*KPW+KPW-1 of a
//    tile) and every warp holds all the call's rows (RMAX = 2 or 8);
//  * a key's head dim goes over LPK = hd / EPL lanes (EPL = 16 elements
//    a lane, 8 when RMAX = 8), so a warp takes KPS = 32 / LPK keys a
//    step; lane li of a group holds the 16-byte chunks c * LPK + li of
//    the row (conflict-free shared-memory reads), q for those elements
//    in registers, and a score is EPL FMAs plus a log2(LPK) shuffle tree;
//  * each warp keeps its own online softmax: m is warp-wide (the max of
//    a chunk of steps over the warp's keys, by shuffles across groups),
//    l and acc (RMAX x EPL registers) are per lane group and summed
//    across the groups once, after the last tile;
//  * the warps merge in shared memory in warp order, and the splits in a
//    second kernel in split order: no atomics, a relaunch is bitwise the
//    same;
//  * the CTA first reads its keys' positions into shared memory, marks
//    each tile in which some key counts for some row and lists those in
//    order; only listed tiles are copied and computed (the causal and
//    window skip, read from the positions themselves).
//
// The C entry point returns cudaGetLastError() after its launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kTileBytes = 16384;       // K bytes of one tile (and V bytes)
constexpr int kMaxKeys = 2048;          // keys of one split (positions kept)
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* k_pos;
  void* out;
  float* part;       // n_split > 1: [n_split][B * Hkv][RMAX][hd + 2]
  int B, Sq, Sk, H, Hkv, group, n_rows;
  int causal, window;
  float softcap, scale;
  int n_split, tiles_per_split;
};

// 16 bytes of T as f32
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void cvt(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void cvt(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // little endian: element 2i is low
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool counts(const Params& p, int kp, int qp,
                                       bool row_ok) {
  bool o = row_ok && kp >= 0;
  if (p.causal) o = o && kp <= qp;
  if (p.window > 0) o = o && kp > qp - p.window;
  return o;
}

// element offset of row r of (b, kvh) in q and out
__device__ __forceinline__ long long row_offset(const Params& p, int b,
                                                int kvh, int r, int hd) {
  const int qi = r / p.group;
  const int h = kvh * p.group + r % p.group;
  return ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * hd;
}

template <typename T, int HD, int RMAX>
struct Cfg {
  static constexpr int EPL = RMAX <= 2 ? 16 : 8;    // elements a lane
  static constexpr int VEC = Vec<T>::kN;            // elements in 16 bytes
  static constexpr int NCH = EPL / VEC;             // 16-byte chunks a lane
  static constexpr int LPK = HD / EPL;              // lanes a key
  static constexpr int KPS = 32 / LPK;              // keys a warp step
  static constexpr int TK = kTileBytes / (HD * static_cast<int>(sizeof(T)));
  static constexpr int KPW = TK / kWarps;           // keys a warp a tile
  static constexpr int NS = KPW / KPS;              // steps a warp a tile
  static constexpr int CS = NS * RMAX <= 16 ? NS : 16 / RMAX;  // a chunk
  static constexpr int MAX_TILES = kMaxKeys / TK;
  static constexpr int CHUNKS = kTileBytes / 16;    // 16-byte copies a tile
  static constexpr int LOADS = CHUNKS / kThreads;   // ... a thread
  static_assert(NCH >= 1 && LPK >= 1 && LPK <= 32 && KPS * LPK == 32, "lanes");
  static_assert(KPW * kWarps == TK && NS * KPS == KPW && NS % CS == 0, "keys");
  static_assert(LOADS * kThreads == CHUNKS, "copies");
  static_assert(kWarps * RMAX * HD * 4 <= kStages * 2 * kTileBytes, "merge");
  // shared memory: the ring, then the keys' positions, tile flags and
  // the list of live tiles, then the merge's per-warp (m, l) and weights
  static constexpr int RING = kStages * 2 * kTileBytes;
  static constexpr int KP = RING;
  static constexpr int FLAGS = KP + kMaxKeys * 4;
  static constexpr int LIST = FLAGS + MAX_TILES * 4;
  static constexpr int NLIVE = LIST + MAX_TILES * 4;
  static constexpr int ML = NLIVE + 16;
  static constexpr int WF = ML + kWarps * RMAX * 2 * 4;
  static constexpr int ROWML = WF + kWarps * RMAX * 4;
  static constexpr int BYTES = ROWML + RMAX * 2 * 4;
};

template <typename T, int HD, int RMAX>
__global__ void __launch_bounds__(kThreads, RMAX <= 2 ? 2 : 1)
    flash_decode_kernel(const Params p) {
  using C = Cfg<T, HD, RMAX>;
  constexpr int EPL = C::EPL, VEC = C::VEC, NCH = C::NCH, LPK = C::LPK;
  constexpr int KPS = C::KPS, TK = C::TK, KPW = C::KPW, NS = C::NS;
  constexpr int CS = C::CS;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  int* kp_s = reinterpret_cast<int*>(smem + C::KP);
  int* flags = reinterpret_cast<int*>(smem + C::FLAGS);
  int* list = reinterpret_cast<int*>(smem + C::LIST);
  int* n_live_s = reinterpret_cast<int*>(smem + C::NLIVE);

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.Hkv;
  const int kvh = bh % p.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane / LPK;
  const int li = lane % LPK;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  int qp[RMAX];
  bool row_ok[RMAX];
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    row_ok[j] = j < p.n_rows;
    qp[j] = row_ok[j] ? p.q_pos[b * p.Sq + j / p.group] : 0;
  }

  // the split's keys: their positions (past Sk: -1, an empty slot), the
  // tiles in which some key counts for some row, and their list in order
  const int n_tiles = (p.Sk + TK - 1) / TK;
  const int t_begin = split * p.tiles_per_split;
  const int n_ts = min(n_tiles, t_begin + p.tiles_per_split) - t_begin;
  const int key0 = t_begin * TK;
  for (int t = tid; t < n_ts; t += kThreads) flags[t] = 0;
  __syncthreads();
  for (int i = tid; i < n_ts * TK; i += kThreads) {
    const int key = key0 + i;
    const int kp = key < p.Sk ? p.k_pos[static_cast<long long>(b) * p.Sk + key]
                              : -1;
    kp_s[i] = kp;
    bool any = false;
#pragma unroll
    for (int j = 0; j < RMAX; ++j) any = any || counts(p, kp, qp[j], row_ok[j]);
    if (any) flags[i / TK] = 1;        // every writer writes 1
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_ts; base += 32) {
      const int t = base + lane;
      const bool f = t < n_ts && flags[t] != 0;
      const unsigned bal = __ballot_sync(kFull, f);
      if (f) list[n + __popc(bal & ((1u << lane) - 1u))] = t;
      n += __popc(bal);
    }
    if (lane == 0) *n_live_s = n;
  }
  __syncthreads();
  const int n_live = *n_live_s;

  // copy the i-th live tile's K and V into stage i % kStages (a key past
  // Sk is zero-filled); one commit group a call, empty past the list
  auto issue = [&](int i) {
    if (i < n_live) {
      const int t0 = key0 + list[i] * TK;
      unsigned char* ks = smem + (i % kStages) * 2 * kTileBytes;
      unsigned char* vs = ks + kTileBytes;
#pragma unroll
      for (int u = 0; u < C::LOADS; ++u) {
        const int c = tid + u * kThreads;
        const int key = t0 + c / (HD / VEC);
        const bool in = key < p.Sk;
        const long long off =
            ((static_cast<long long>(b) * p.Sk + (in ? key : 0)) * p.Hkv +
             kvh) * HD + (c % (HD / VEC)) * VEC;
        cp_async16(ks + c * 16, k + off, in ? 16 : 0);
        cp_async16(vs + c * 16, v + off, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // this lane's slice of every row of q, as f32; rows past n_rows are 0
  float qr[RMAX][EPL];
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (row_ok[j])
        raw = *reinterpret_cast<const uint4*>(
            q + row_offset(p, b, kvh, j, HD) + (c * LPK + li) * VEC);
      Vec<T>::cvt(raw, &qr[j][c * VEC]);
    }
  }

  float m[RMAX], l[RMAX], acc[RMAX][EPL];
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.f;
  }

  for (int i = 0; i < n_live; ++i) {
    cp_async_wait<kStages - 2>();      // this thread's copies of tile i
    __syncthreads();                   // everyone's; tile i-1 retired
    issue(i + kStages - 1);
    const T* ks = reinterpret_cast<const T*>(smem + (i % kStages) * 2 *
                                             kTileBytes);
    const T* vs = ks + TK * HD;
    const int* kpt = kp_s + list[i] * TK;
#pragma unroll
    for (int c0 = 0; c0 < NS; c0 += CS) {
      float s[CS][RMAX];
      int kpv[CS];
#pragma unroll
      for (int cc = 0; cc < CS; ++cc) {
        const int kt = warp * KPW + (c0 + cc) * KPS + grp;
        kpv[cc] = kpt[kt];
        float kf[EPL];
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          Vec<T>::cvt(*reinterpret_cast<const uint4*>(
                          ks + kt * HD + (c * LPK + li) * VEC),
                      &kf[c * VEC]);
#pragma unroll
        for (int j = 0; j < RMAX; ++j) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) a = fmaf(qr[j][e], kf[e], a);
          s[cc][j] = a;
        }
      }
      // the key's score: the sum over its group's lanes
#pragma unroll
      for (int cc = 0; cc < CS; ++cc)
#pragma unroll
        for (int j = 0; j < RMAX; ++j)
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1)
            s[cc][j] += __shfl_xor_sync(kFull, s[cc][j], o);
      // logits, the mask, then the chunk's max over the warp's keys
#pragma unroll
      for (int j = 0; j < RMAX; ++j) {
        float mx = -INFINITY;
#pragma unroll
        for (int cc = 0; cc < CS; ++cc) {
          float x = s[cc][j] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          x = counts(p, kpv[cc], qp[j], row_ok[j]) ? x : -INFINITY;
          s[cc][j] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        if (mx > m[j]) {                 // warp-uniform
          const float alpha = m[j] == -INFINITY ? 0.f : expf(m[j] - mx);
          l[j] *= alpha;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[j][e] *= alpha;
          m[j] = mx;
        }
#pragma unroll
        for (int cc = 0; cc < CS; ++cc) {
          const float pr = s[cc][j] == -INFINITY ? 0.f : expf(s[cc][j] - m[j]);
          s[cc][j] = pr;
          l[j] += pr;
        }
      }
      // acc += p . v over the chunk's keys
#pragma unroll
      for (int cc = 0; cc < CS; ++cc) {
        const int kt = warp * KPW + (c0 + cc) * KPS + grp;
        float vf[EPL];
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          Vec<T>::cvt(*reinterpret_cast<const uint4*>(
                          vs + kt * HD + (c * LPK + li) * VEC),
                      &vf[c * VEC]);
#pragma unroll
        for (int j = 0; j < RMAX; ++j)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[j][e] = fmaf(s[cc][j], vf[e], acc[j][e]);
      }
    }
  }
  cp_async_wait<0>();                  // only empty groups are left

  // the warp's total: l and acc summed over its key groups
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
      l[j] += __shfl_xor_sync(kFull, l[j], o);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[j][e] += __shfl_xor_sync(kFull, acc[j][e], o);
    }
  }
  __syncthreads();                     // every warp is done with the ring

  // merge the warps in warp order
  float* mo = reinterpret_cast<float*>(smem);            // [warp][row][HD]
  float* ml = reinterpret_cast<float*>(smem + C::ML);    // [warp][row][2]
  float* wf = reinterpret_cast<float*>(smem + C::WF);    // [warp][row]
  float* rml = reinterpret_cast<float*>(smem + C::ROWML);  // [row][2]
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < RMAX; ++j)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          mo[(warp * RMAX + j) * HD + (c * LPK + li) * VEC + e] =
              acc[j][c * VEC + e];
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < RMAX; ++j) {
      ml[(warp * RMAX + j) * 2] = m[j];
      ml[(warp * RMAX + j) * 2 + 1] = l[j];
    }
  }
  __syncthreads();
  if (tid < RMAX) {
    const int j = tid;
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ml[(w * RMAX + j) * 2]);
    float L = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = ml[(w * RMAX + j) * 2];
      const float f = mw == -INFINITY ? 0.f : expf(mw - M);
      wf[w * RMAX + j] = f;
      L = fmaf(ml[(w * RMAX + j) * 2 + 1], f, L);
    }
    rml[2 * j] = M;
    rml[2 * j + 1] = L;
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out);
  const long long part_row =
      (static_cast<long long>(split) * gridDim.y + bh) * RMAX;
  for (int idx = tid; idx < p.n_rows * HD; idx += kThreads) {
    const int j = idx / HD;
    const int d = idx % HD;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      o = fmaf(mo[(w * RMAX + j) * HD + d], wf[w * RMAX + j], o);
    const float L = rml[2 * j + 1];
    if (p.n_split == 1) {
      store1(out + row_offset(p, b, kvh, j, HD) + d, L > 0.f ? o / L : 0.f);
    } else {
      float* dst = p.part + (part_row + j) * (HD + 2);
      dst[d] = o;
      if (d == 0) {
        dst[HD] = rml[2 * j];
        dst[HD + 1] = L;
      }
    }
  }
}

// Second pass of a split launch: out = sum_z o_z e^(m_z - M) /
// sum_z l_z e^(m_z - M) over the splits z in order, M = max_z m_z; a
// split in which no key counted (m_z = -inf) weighs 0.
template <typename T, int HD, int RMAX>
__global__ void __launch_bounds__(kThreads)
    flash_decode_combine(const Params p) {
  const int bh = blockIdx.x;
  const int b = bh / p.Hkv;
  const int kvh = bh % p.Hkv;
  const long long stride = static_cast<long long>(gridDim.x) * RMAX * (HD + 2);
  T* out = static_cast<T*>(p.out);
  for (int idx = threadIdx.x; idx < p.n_rows * HD; idx += kThreads) {
    const int j = idx / HD;
    const int d = idx % HD;
    const float* src = p.part + (static_cast<long long>(bh) * RMAX + j) * (HD + 2);
    float M = -INFINITY;
    for (int z = 0; z < p.n_split; ++z) M = fmaxf(M, src[z * stride + HD]);
    float L = 0.f, o = 0.f;
    if (M != -INFINITY) {
      for (int z = 0; z < p.n_split; ++z) {
        const float* part = src + z * stride;
        const float w = part[HD] == -INFINITY ? 0.f : expf(part[HD] - M);
        L = fmaf(part[HD + 1], w, L);
        o = fmaf(part[d], w, o);
      }
    }
    store1(out + row_offset(p, b, kvh, j, HD) + d, L > 0.f ? o / L : 0.f);
  }
}

template <typename T, int HD, int RMAX>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  using C = Cfg<T, HD, RMAX>;
  if (p.tiles_per_split > C::MAX_TILES) return cudaErrorInvalidValue;
  // the opt-in holds per device, so it is set on every launch (cheap)
  cudaError_t e = cudaFuncSetAttribute(
      flash_decode_kernel<T, HD, RMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.n_split, p.B * p.Hkv);
  flash_decode_kernel<T, HD, RMAX><<<grid, kThreads, C::BYTES, stream>>>(p);
  if (p.n_split > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_decode_combine<T, HD, RMAX>
        <<<p.B * p.Hkv, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T, int RMAX>
cudaError_t launch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_typed<T, 64, RMAX>(p, stream);
    case 128: return launch_typed<T, 128, RMAX>(p, stream);
    case 256: return launch_typed<T, 256, RMAX>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_rows(const Params& p, int rows, int hd,
                        cudaStream_t stream) {
  switch (rows) {
    case 2: return launch_hd<T, 2>(p, hd, stream);
    case 8: return launch_hd<T, 8>(p, hd, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  rows: 2 or 8, at least Sq * H / Hkv.
// window <= 0: no window; softcap <= 0: none.  Split z takes key tiles
// [z * tiles_per_split, (z + 1) * tiles_per_split) of kTileBytes /
// (hd * sizeof) keys; tiles_per_split at most kMaxKeys of them.  n_split
// > 1 needs part: n_split * B * Hkv * rows * (hd + 2) floats.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* k_pos, void* out,
                        float* part, int dtype, int B, int Sq, int Sk, int H,
                        int Hkv, int hd, int rows, int causal, int window,
                        float softcap, float scale, int n_split,
                        int tiles_per_split, cudaStream_t stream) {
  if (Hkv <= 0 || H % Hkv != 0 || Sq < 1 || Sq * (H / Hkv) > rows ||
      n_split < 1 || tiles_per_split < 1 || B * Hkv > 65535 ||
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
  p.n_rows = Sq * p.group;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  p.n_split = n_split;
  p.tiles_per_split = tiles_per_split;
  cudaError_t e = dtype == 0   ? launch_rows<float>(p, rows, hd, stream)
                  : dtype == 1 ? launch_rows<__nv_bfloat16>(p, rows, hd, stream)
                               : cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"
