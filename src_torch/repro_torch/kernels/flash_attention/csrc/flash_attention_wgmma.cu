// Flash-attention prefill on Hopper's tensor cores (sm_90a): bf16 inputs,
// f32 accumulation, explicit positions.
//
// Replaces, for bf16 calls with at least 64 query rows, the reference's
// Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:85
// flash_attention_bhsd (pallas_call :107, body _kernel :31).  It computes
// the same function as the CUDA-core kernel beside it (flash_attention.cu,
// which keeps decode and every f32 call): s = (q . k) * scale in f32, then
// softcap * tanh(s / softcap) when a softcap is set; key j counts for
// query i when k_pos[j] >= 0, k_pos[j] <= q_pos[i] (causal) and k_pos[j] >
// q_pos[i] - window (window > 0); softmax over the keys that count, times
// v, accumulated in f32, normalised and stored as bf16 in q's layout.  A
// row where no key counts is 0.
//
// Layout: q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), out like q, all
// contiguous bf16; H = Hkv * group, query head h = kvh * group + g.
// q_pos (B, Sq), k_pos (B, Sk) int32.
//
// What bounds it: bf16 tensor-core operations.  At the served prefill
// (gemma2-2b, B=4, S=5120, 8 heads over 4 KV heads of 256) the causal
// pairs need 4.3e14 FLOP of q.k and p.v, 434 us at 989 TFLOP/s; the
// hi/lo split of P below doubles the p.v products, so the kernel issues
// 1.5x that.  Its bytes (q, k, v, out: 84 MB at 3.35 TB/s, 25 us) do not
// bound it.
//
// Design:
// 1. Work split.  One CTA of three warpgroups takes one (batch, KV head,
//    query block): bq = 128 / group queries times the group heads that
//    share the KV head, so each K/V tile is read once for the whole
//    group.  Row r of the block is query q0 + r / group, head
//    kvh * group + r % group (group 9 or 12 leaves 126 or 120 live rows;
//    the rest are neither masked in nor stored).  Warpgroup 0 is the
//    producer, warpgroups 1 and 2 consume 64 rows each.  Query blocks are
//    launched longest first (the causal blocks at the end of the
//    sequence see the most keys).
// 2. Loads.  TMA with mbarriers, all tiles 128-byte swizzled in rows of
//    64 columns (a row of hd = 256 is 512 bytes, so a tile comes in as
//    hd / 64 sub-tiles).  Q is loaded once per CTA through a 4-D tensor
//    map over (hd, H, Sq, B) with box (64, group, bq, 1).  K and V come
//    in tiles of kBc = 64 keys through a ring of kStages = 2 stages, from
//    maps over (hd, Hkv, Sk, B); K and V of a stage have their own
//    full barriers, so Q.K^T starts before V lands, and one empty barrier
//    the consumer warps release after P.V.  Shared memory at hd = 256:
//    Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB.  Ragged Sq/Sk edges come
//    in as zeros (TMA's out-of-bounds fill) and are masked.  The tensor
//    maps are encoded on the host for each launch, cuTensorMapEncodeTiled
//    reached through cudaGetDriverEntryPoint (no -lcuda).
// 3. S = Q.K^T: wgmma m64n64k16, bf16 operands from shared memory (both
//    K-major), f32 accumulator.  bf16 x bf16 products are exact in f32, so
//    this is the reference's f32 dot of the same bf16 values up to the
//    order of the sum.  Then, on the f32 accumulator and in the CUDA-core
//    kernel's order: times the scale, the softcap, the mask.  The scale
//    is folded into the softcap's argument (s * (scale / c)) and log2(e)
//    into its result, so the softmax runs on ex2; tanh is a branch-free
//    f32 form within 1.2e-7 (tanhf's 2 ulp), ex2 and the reciprocal in it
//    the hardware's approximations (2^-22).
// 4. Online softmax in registers: each thread holds 2 rows x 16 keys of
//    S; row max and sum over the thread's values in order, then over the
//    4 lanes of a row by xor-shuffles 1 and 2.  O is rescaled only when a
//    row of the warp moved its max.  No atomics and no key split, so a
//    relaunch is bitwise the same.
// 5. P.V keeps the reference's f32 precision: P = hi + lo with
//    hi = bf16(P) and lo = bf16(P - hi) (P to ~2^-17), two wgmma
//    m64n(hd)k16 with A from registers (the S accumulator's layout is the
//    A fragment's) into the same f32 accumulator; V is the MN-major B
//    operand (transpose bit set).  A single bf16 P (2^-9) is not built.
// 6. Masks come from the positions.  A pre-pass kernel reduces k_pos to a
//    (min, max, count) of the live keys of each tile; a CTA reduces its
//    queries' positions to (min, max) and marks each key tile: skipped
//    (no live key; every key after the block's last query; every key at
//    or before the block's first query - window), whole (64 live keys
//    that count for every row: no per-element mask) or masked.  A skipped
//    tile is neither loaded nor computed: the causal and window skip, read
//    from the positions, so a chunked prefill or a ring is served too.
// 7. The consumers take turns at the tensor cores (two named barriers):
//    in its turn a warpgroup issues P.V of its tile and Q.K^T of the next,
//    then runs its softmax while the other warpgroup's products run.
// 8. Registers: setmaxnreg gives the producer 24 and the consumers 240
//    (O accumulator 128 f32 at hd = 256, S 32, P hi/lo 32).  Only the
//    producer may trap (its watchdog): a trap reachable from the
//    consumers joins the two budgets and caps them at the launch's 168.
// 9. Output: O / l stored as bf16 pairs in q's layout, live rows only.
//
// The C entry point returns cudaGetLastError() after its launches.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBc = 64;             // keys per tile
constexpr int kRows = 128;          // query rows per CTA: 2 warpgroups x 64
constexpr int kStages = 2;          // K/V ring depth
constexpr int kThreads = 384;       // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;
constexpr int kRowBytes = 128;      // one swizzled row: 64 bf16
constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -kIntMax - 1;
constexpr unsigned kFull = 0xffffffffu;

// key tile states
constexpr uint8_t kSkip = 0;
constexpr uint8_t kWhole = 1;       // every key counts for every row
constexpr uint8_t kMasked = 2;

struct Params {
  const int* q_pos;
  const int* k_pos;
  const int4* tiles;      // [B][n_ktiles]: live key positions min, max, count
  __nv_bfloat16* out;
  int B, Sq, Sk, H, Hkv, group, bq, n_qblocks, n_ktiles;
  int causal, window;
  float softcap;      // > 0: the softcap is on
  float arg_scale;    // scale / softcap: the softcap's tanh argument
  float cap_log2;     // softcap * log2(e): its result in log2 units
  float scale_log2;   // scale * log2(e): the score without a softcap
};

// shared memory, from a 1024-byte aligned base (the swizzle's period)
template <int HD>
struct Smem {
  static constexpr int kSub = HD / 64;             // 64-column sub-tiles
  static constexpr int kQSub = kRows * kRowBytes;  // 16 KB
  static constexpr int kKVSub = kBc * kRowBytes;   // 8 KB
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kSub * kQSub;
  static constexpr int kV = kK + kStages * kSub * kKVSub;
  static constexpr int kBar = kV + kStages * kSub * kKVSub;
  // barriers: Q full, K full x kStages, V full x kStages, empty x kStages
  static constexpr int kState = kBar + 8 * (1 + 3 * kStages);
  static int bytes(int n_ktiles) { return kState + ((n_ktiles + 15) & ~15) + 1024; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
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

// Wait for the phase of parity ``parity`` to complete (consumers).
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  while (!bar_test(bar, parity)) {
  }
}

// The producer's wait: one that outlasts 2^34 clocks (~9 s; a tile takes
// microseconds) traps, so a broken pipeline fails its launch instead of
// hanging the card.  Only the producer traps: a trap reached from the
// consumers' code joins the two register budgets of setmaxnreg and caps
// the consumers at the launch budget (168), which spills the O
// accumulator.  The producer's last waits (Q, and the release of every
// stage in flight) cover every wait of the consumers.
__device__ __forceinline__ void bar_wait_or_trap(uint32_t bar,
                                                 uint32_t parity) {
  const long long t0 = clock64();
  while (!bar_test(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// one box of a 4-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving an accumulator across an async wgmma
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) . B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, registers) . B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 64) wgmma_rs_n64(o, a, b);
  else if constexpr (HD == 128) wgmma_rs_n128(o, a, b);
  else wgmma_rs_n256(o, a, b);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// A key tile's state for a query block whose positions span [qmin, qmax],
// from the tile's live key positions (min lo, max hi, count n)
__device__ __forceinline__ uint8_t tile_state(int4 s, int qmin, int qmax,
                                              int causal, int window) {
  const long long lo = s.x, hi = s.y;
  if (s.z == 0) return kSkip;
  if (causal && lo > qmax) return kSkip;
  if (window > 0 && hi <= static_cast<long long>(qmin) - window) return kSkip;
  const bool whole = s.z == kBc && (!causal || hi <= qmin) &&
                     (window <= 0 || lo > static_cast<long long>(qmax) - window);
  return whole ? kWhole : kMasked;
}

// Pre-pass: (min, max, count) of the live (k_pos >= 0) key positions of
// each tile of kBc keys; one warp per (tile, batch row).
__global__ void __launch_bounds__(32)
    flash_attention_tile_summary(const int* __restrict__ k_pos, int Sk,
                                 int n_ktiles, int4* __restrict__ tiles) {
  const int t = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  int lo = kIntMax, hi = kIntMin, n = 0;
#pragma unroll
  for (int j = lane; j < kBc; j += 32) {
    const int key = t * kBc + j;
    const int kp = key < Sk ? k_pos[static_cast<long long>(b) * Sk + key] : -1;
    if (kp >= 0) {
      lo = min(lo, kp);
      hi = max(hi, kp);
      ++n;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, o));
    hi = max(hi, __shfl_xor_sync(kFull, hi, o));
    n += __shfl_xor_sync(kFull, n, o);
  }
  if (lane == 0)
    tiles[static_cast<long long>(b) * n_ktiles + t] = make_int4(lo, hi, n, 0);
}

// A consumer thread's two rows: row0 and row0 + 8 of the block, whether
// each is a live query row, its query position, and the thread's lane in
// its row quad
struct Rows {
  int row0, quad;
  bool live[2];
  int qp[2];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh in f32 without branches: x + x^3 Q(x^2) below |x| = 0.6 (a fit
// within 4e-8), 1 - 2 / (e^{2|x|} + 1) with x's sign above (within
// 1.2e-7); tanhf's 2 ulp are ~1.2e-7 near 1.  Its branch per element costs
// more than both halves.
__device__ __forceinline__ float tanh_f32(float x) {
  const float a = fabsf(x);
  const float big = fmaf(-2.f, rcp(ex2(a * 2.8853900817779268f) + 1.f), 1.f);
  const float y = x * x;
  float q = -0.005984960589557886f;
  q = fmaf(q, y, 0.020868148654699326f);
  q = fmaf(q, y, -0.053803566843271255f);
  q = fmaf(q, y, 0.13332132995128632f);
  q = fmaf(q, y, -0.3333330452442169f);
  const float small = fmaf(x * y, q, x);
  return a < 0.6f ? small : copysignf(big, x);
}

// named barriers 1 and 2: warpgroup wg's turn at the tensor cores
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// S = Q . K^T over hd in steps of 16 (32 bytes along a swizzled row):
// Q's rows and K's keys both K-major, 8-row groups 1024 bytes apart
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_addr,
                                         uint32_t k_addr) {
  const uint64_t qd = make_desc(q_addr, 16, 8 * kRowBytes);
  const uint64_t kd = make_desc(k_addr, 16, 8 * kRowBytes);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    wgmma_ss_n64(sc, qd + (((ks >> 2) * Smem<HD>::kQSub + (ks & 3) * 32) >> 4),
                 kd + (((ks >> 2) * Smem<HD>::kKVSub + (ks & 3) * 32) >> 4),
                 ks > 0);
}

// O += P . V with P = hi + lo: V's 64-column sub-tiles are the MN-major
// atoms, kKVSub bytes apart (leading byte offset), 8-key groups 1024
// bytes apart (stride); k-step kk takes keys 16 kk .. 16 kk + 15
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<HD>(o, hi[kk], make_desc(v_addr + kk * 16 * kRowBytes,
                                      Smem<HD>::kKVSub, 8 * kRowBytes));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<HD>(o, lo[kk], make_desc(v_addr + kk * 16 * kRowBytes,
                                      Smem<HD>::kKVSub, 8 * kRowBytes));
}

// Bit j: whether the key of accumulator register j counts for its row,
// for a tile that needs the per-element mask
__device__ __forceinline__ uint32_t mask_bits(const Rows& rows,
                                              const int* k_pos, int t,
                                              const Params& p) {
  int kp[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int key = t * kBc + 8 * (c >> 1) + 2 * rows.quad + (c & 1);
    kp[c] = key < p.Sk ? k_pos[key] : -1;
  }
  uint32_t bits = 0;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bool ok = rows.live[h] && kp[c] >= 0;
      if (p.causal) ok = ok && kp[c] <= rows.qp[h];
      if (p.window > 0) ok = ok && kp[c] > rows.qp[h] - p.window;
      bits |= static_cast<uint32_t>(ok) << (4 * (c >> 1) + 2 * h + (c & 1));
    }
  }
  return bits;
}

// On a tile's scores: the scale and the softcap, in log2 units (the scale
// folded into the softcap's argument, c log2(e) into its result), the
// mask, and the online softmax: m and l in log2 units, P (f32) in place
// of the scores; returns each row's rescale factor for O in alpha
__device__ __forceinline__ void softmax(float (&sc)[32], uint32_t bits,
                                        float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], const Params& p) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float x = p.softcap > 0.f
                        ? p.cap_log2 * tanh_f32(sc[j] * p.arg_scale)
                        : sc[j] * p.scale_log2;
    sc[j] = (bits >> j) & 1 ? x : -INFINITY;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 2 * h; j < 32; j += 4) mx = fmaxf(mx, fmaxf(sc[j], sc[j + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_use = mx == -INFINITY ? 0.f : mx;
    alpha[h] = ex2(m[h] - m_use);    // 0 on a row's first live tile
    m[h] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 2 * h; j < 32; j += 4) {
      sc[j] = ex2(sc[j] - m_use);
      sc[j + 1] = ex2(sc[j + 1] - m_use);
      sum += sc[j];
      sum += sc[j + 1];
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    l[h] = l[h] * alpha[h] + sum;
  }
}

// O rescaled by alpha (skipped when no row of the warp moved its max), and
// P split into bf16 hi + lo packed as the wgmma A fragment: k-step kk
// takes accumulator registers 8 kk .. 8 kk + 7
template <int HD>
__device__ __forceinline__ void rescale_split(const float (&sc)[32],
                                              const float (&alpha)[2],
                                              float (&o)[HD / 2],
                                              uint32_t (&hi)[4][4],
                                              uint32_t (&lo)[4][4]) {
  if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h2);
      hi[kk][r] = bf16x2_bits(h2);
      lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const Params p) {
  using L = Smem<HD>;
  constexpr int kSub = L::kSub;
  constexpr int NO = HD / 2;       // O accumulator registers per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;                  // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;
  uint8_t* state = smem + L::kState;

  const int b = blockIdx.x / p.Hkv;
  const int kvh = blockIdx.x % p.Hkv;
  const int q0 = (p.n_qblocks - 1 - static_cast<int>(blockIdx.y)) * p.bq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the warpgroup, through a shuffle so that the compiler sees it is
  // uniform and gives each role its own register budget (setmaxnreg)
  const int role = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      bar_init(k_full + 8 * s, 1);
      bar_init(v_full + 8 * s, 1);
      bar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == 1) {
    // the block's query positions, then the state of every key tile
    int qmin = kIntMax, qmax = kIntMin;
    const int nq = min(p.bq, p.Sq - q0);
    for (int i = lane; i < nq; i += 32) {
      const int qp = p.q_pos[static_cast<long long>(b) * p.Sq + q0 + i];
      qmin = min(qmin, qp);
      qmax = max(qmax, qp);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(kFull, qmin, o));
      qmax = max(qmax, __shfl_xor_sync(kFull, qmax, o));
    }
    const int4* tiles = p.tiles + static_cast<long long>(b) * p.n_ktiles;
    for (int t = lane; t < p.n_ktiles; t += 32)
      state[t] = tile_state(tiles[t], qmin, qmax, p.causal, p.window);
  }
  __syncthreads();

  if (role == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      bar_expect_tx(q_full, kSub * p.bq * p.group * kRowBytes);
      for (int j = 0; j < kSub; ++j)
        tma_load(base + L::kQ + j * L::kQSub, &tm_q, q_full, 64 * j,
                 kvh * p.group, q0, b);
      int i = 0;
      for (int t = 0; t < p.n_ktiles; ++t) {
        if (state[t] == kSkip) continue;
        const int s = i % kStages;
        bar_wait_or_trap(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        bar_expect_tx(k_full + 8 * s, kSub * L::kKVSub);
        for (int j = 0; j < kSub; ++j)
          tma_load(base + L::kK + (s * kSub + j) * L::kKVSub, &tm_k,
                   k_full + 8 * s, 64 * j, kvh, t * kBc, b);
        bar_expect_tx(v_full + 8 * s, kSub * L::kKVSub);
        for (int j = 0; j < kSub; ++j)
          tma_load(base + L::kV + (s * kSub + j) * L::kKVSub, &tm_v,
                   v_full + 8 * s, 64 * j, kvh, t * kBc, b);
        ++i;
      }
      // the tail: Q landed, and the consumers released every stage
      bar_wait_or_trap(q_full, 0);
      for (int j = i < kStages ? 0 : i - kStages; j < i; ++j)
        bar_wait_or_trap(empty + 8 * (j % kStages), (j / kStages) & 1);
    }
    return;
  }

  // consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63; this thread
  // holds rows row0 and row0 + 8, and of each tile the 16 keys
  // 8 c + 2 quad + e (c < 8, e < 2), as the wgmma accumulator lays them out
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = role - 1;
  Rows rows;
  rows.row0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  rows.quad = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows.row0 + 8 * h;
    const int qi = q0 + r / p.group;
    rows.live[h] = r < p.bq * p.group && qi < p.Sq;
    rows.qp[h] = rows.live[h] ? p.q_pos[static_cast<long long>(b) * p.Sq + qi] : 0;
  }
  float o[NO], sc[32];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) sc[j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = base + L::kQ + wg * 64 * kRowBytes;
  const int* k_pos = p.k_pos + static_cast<long long>(b) * p.Sk;

  // The two warpgroups take turns at the tensor cores (named barriers 1
  // and 2): in its turn a warpgroup issues P.V of its tile and Q.K^T of
  // the next one, then passes the turn and runs the next softmax while
  // the other's products run.  Each warpgroup takes one turn more than it
  // has tiles; warpgroup 0 opens the first, warpgroup 1 passes none after
  // its last.  (Running the softmax beside the warpgroup's own P.V too,
  // after a wait for Q.K^T alone and with the last tile peeled off so that
  // ptxas can track the two groups, gave the same bytes but ran slower on
  // an H100 at the served prefill.)
  bar_wait(q_full, 0);
  int t = 0;
  while (t < p.n_ktiles && state[t] == kSkip) ++t;
  uint32_t bits = ~0u;
  if (t < p.n_ktiles) {
    if (wg == 0) turn_pass(1);         // opens warpgroup 0's first turn
    turn_wait(wg);
    bar_wait(k_full, 0);
    wgmma_fence();
    issue_qk<HD>(sc, q_addr, base + L::kK);
    wgmma_commit();
    turn_pass(wg);
    if (state[t] == kMasked) bits = mask_bits(rows, k_pos, t, p);
    wgmma_wait_all();
    pin(sc);
  }
  for (int i = 0; t < p.n_ktiles; ++i) {
    const int s = i % kStages;
    int tn = t + 1;
    while (tn < p.n_ktiles && state[tn] == kSkip) ++tn;
    const bool next = tn < p.n_ktiles;

    uint32_t hi[4][4], lo[4][4];
    float alpha[2];
    softmax(sc, bits, m, l, alpha, p);
    rescale_split<HD>(sc, alpha, o, hi, lo);

    turn_wait(wg);
    bar_wait(v_full + 8 * s, (i / kStages) & 1);
    wgmma_fence();
    issue_pv<HD>(o, hi, lo, base + L::kV + s * kSub * L::kKVSub);
    if (next) {
      const int sn = (i + 1) % kStages;
      bar_wait(k_full + 8 * sn, ((i + 1) / kStages) & 1);
      issue_qk<HD>(sc, q_addr, base + L::kK + sn * kSub * L::kKVSub);
    }
    wgmma_commit();
    if (wg == 0 || next) turn_pass(wg);
    bits = ~0u;
    if (next && state[tn] == kMasked) bits = mask_bits(rows, k_pos, tn, p);
    wgmma_wait_all();
    pin(o);
    pin(sc);
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * s);
    t = tn;
  }

  // O / l as bf16 pairs, live rows only
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rows.live[h]) continue;
    const int r = rows.row0 + 8 * h;
    __nv_bfloat16* dst =
        p.out + ((static_cast<long long>(b) * p.Sq + q0 + r / p.group) * p.H +
                 kvh * p.group + r % p.group) * HD + 2 * rows.quad;
    // one reciprocal a row (within 2 ulp; the result is rounded to bf16):
    // an IEEE division per element would call its slow path from here,
    // and a call caps the region at the kernel's launch register budget
    const float inv = l[h] > 0.f ? __fdividef(1.f, l[h]) : 0.f;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) = __floats2bfloat162_rn(
          o[4 * c + 2 * h] * inv, o[4 * c + 2 * h + 1] * inv);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 (rows, S, heads, hd) tensor as a 4-D map (hd, heads, S, rows)
// read in boxes of (64, box_heads, box_rows, 1), 128-byte swizzled,
// out-of-bounds elements read as zero
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hd,
            int heads, int S, int rows, int box_heads, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(hd) * 2,
      static_cast<cuuint64_t>(hd) * heads * 2,
      static_cast<cuuint64_t>(hd) * heads * S * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_typed(const CUtensorMap& tq, const CUtensorMap& tk,
                         const CUtensorMap& tv, const Params& p,
                         cudaStream_t stream) {
  const int bytes = Smem<HD>::bytes(p.n_ktiles);
  // the opt-in holds per device, so it is set on every launch (cheap)
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  flash_attention_wgmma_kernel<HD>
      <<<dim3(p.B * p.Hkv, p.n_qblocks), kThreads, bytes, stream>>>(tq, tk,
                                                                    tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, k, v, out; hd 64, 128 or 256; H / Hkv <= 128.  tiles: scratch
// of B * ceil(Sk / 64) int4.  window <= 0: no window; softcap <= 0: none.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 const int* q_pos, const int* k_pos, void* out,
                                 void* tiles, int B, int Sq, int Sk, int H,
                                 int Hkv, int hd, int causal, int window,
                                 float softcap, float scale,
                                 cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 ||
      H / Hkv > kRows || (hd != 64 && hd != 128 && hd != 256) ||
      tiles == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q_pos = q_pos;
  p.k_pos = k_pos;
  p.tiles = static_cast<const int4*>(tiles);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.Hkv = Hkv;
  p.group = H / Hkv;
  p.bq = kRows / p.group;
  p.n_qblocks = (Sq + p.bq - 1) / p.bq;
  p.n_ktiles = (Sk + kBc - 1) / kBc;
  p.causal = causal;
  p.window = window;
  const double kLog2e = 1.4426950408889634;
  p.softcap = softcap;
  p.arg_scale = softcap > 0.f ? static_cast<float>(static_cast<double>(scale) / softcap) : 0.f;
  p.cap_log2 = static_cast<float>(softcap * kLog2e);
  p.scale_log2 = static_cast<float>(scale * kLog2e);
  if (p.n_qblocks > 65535) return static_cast<int>(cudaErrorInvalidValue);

  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, hd, H, Sq, B, p.group, p.bq) ||
      !encode(fn, &tk, k, hd, Hkv, Sk, B, 1, kBc) ||
      !encode(fn, &tv, v, hd, Hkv, Sk, B, 1, kBc))
    return static_cast<int>(cudaErrorInvalidValue);

  flash_attention_tile_summary<<<dim3(p.n_ktiles, B), 32, 0, stream>>>(
      k_pos, Sk, p.n_ktiles, static_cast<int4*>(tiles));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (hd) {
    case 64: e = launch_typed<64>(tq, tk, tv, p, stream); break;
    case 128: e = launch_typed<128>(tq, tk, tv, p, stream); break;
    default: e = launch_typed<256>(tq, tk, tv, p, stream); break;
  }
  return static_cast<int>(e);
}

}  // extern "C"
