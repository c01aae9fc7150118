// Flash-attention forward (GQA prefill) for Hopper: two routes, both on the
// tensor cores.
//
// Replaces the Pallas TPU kernel flash_attention_fwd (_flash_kernel) of
// src/repro/kernels/flash_attention/kernel.py: q [B, Hq, Sq, dh] against
// k, v [B, Hkv, Sk, dh], query head h reading KV head h / G (G = Hq / Hkv)
// with no broadcast copy; causal (key <= query) and sliding-window
// (key > query - window) masks, the query at row i standing at position
// i + q_offset; float32 or bfloat16 in and out, every statistic in float32.
//
// The TPU kernel walks KV blocks on a sequential grid axis with (m, l, acc)
// in VMEM scratch. Here one block owns a tile of query rows of one (batch,
// query head) and loops over the KV tiles (64 keys; 32 or 16 on the
// split route) its mask can reach;
// the loop takes the place of the sequential grid axis, and the
// online-softmax state stays in registers. Tiles wholly outside the mask
// are skipped: the reference's update leaves (m, l, acc) unchanged on such
// a tile, so skipping is exact.
//
// Per tile, as _flash_kernel: s = sm_scale * (q . k), soft-capped to
// softcap * tanhf(s / softcap) where the caller sets a cap (the reference
// model's attn_logit_softcap, before the mask; the Pallas kernel has no
// cap, its twin blocked_attention has), masked to -1e30;
// m_new = max(m, rowmax s); m_safe = (m_new <= -1e30 / 2) ? 0 : m_new;
// p = masked ? 0 : expf(s - m_safe); corr = (m <= -1e30 / 2) ? 0 :
// expf(m - m_safe); l = l * corr + sum p; acc = acc * corr + p . v; and at
// the end o = acc / max(l, 1e-30) (a fully masked row gives 0).
//
// Bound: operations -- 4 * dh flops per unmasked (query, key) pair per
// query head.
//
// bf16 route (flash_wgmma_kernel<DHP, 1>; bfloat16, dh <= 256). One warpgroup
// (128 threads) owns 64 query rows. Q and a 2-stage ring of K/V tiles arrive
// by TMA on mbarriers, each 64-row tile as boxes of 64 columns (128-byte
// rows: one box for dh <= 64, two up to 128, three up to 192, four up to 256)
// in the 128-byte swizzle that wgmma reads: 2 NB TMA instructions a K/V tile,
// each moving whole 128-byte lines. (Boxes of 8 columns, the unswizzled
// core-matrix layout, take 32 instructions and 2,048 half-used sectors a
// tile; on an H100 at the jamba prefill, loading alone then took 0.325 ms of
// the kernel's 0.332 ms.) dh is padded in shared memory to DHP (64, 80, 128,
// 160, 192 or 256; the wrapper picks it) by the tensor map's zero fill of the
// columns past dh (the third box at DHP 160 is half filled: columns 160-191
// are zeros no wgmma reads), and rows past Sq / Sk are zero-filled the same
// way.
// Up to DHP 128 a block is one warpgroup (Q, two K and two V tiles: 80 KB
// at DHP 128, two blocks an SM). Above, the same layout would leave one
// 4-warp block an SM (120 KB at DHP 160); so a block there is two
// warpgroups over 128 query rows that share each K/V stage (two Q tiles,
// two K and two V tiles: 144 KB at DHP 160 and 192, 192 KB at 256; one
// 8-warp block an SM, half the K/V bytes a query row). Each warpgroup skips
// the tiles its own 64 rows cannot reach, and meets every stage's release
// all the same.
// S = Q . K^T is a wgmma m64n64k16 chain over DHP / 16 steps with both
// operands K-major in shared memory (bf16 products are exact in the f32
// accumulator); the scale, the mask and the online softmax run on the
// accumulator fragment in registers (each thread holds 2 rows x 16 keys;
// a row's four threads reduce with two xor shuffles). O += P . V takes P
// from registers and V from shared memory as an MN-major operand
// (m64nDHPk16: N 160 spans two boxes and half a third, 192 and 256 three
// and four whole boxes). P is carried in three bf16 parts, P_hi + P_mid +
// P_lo (each the bf16 of what the parts before it leave of p), three
// wgmmas into the same f32 accumulator: the parts hold p to 2^-27 of
// itself. A bf16 P alone misses one bf16 ulp of the f32 result by two
// orders of magnitude, and two parts (2^-18) still missed it by up to 1.6x
// on an H100, on outputs near zero of rows with few keys, where the limit
// is about 1e-6 absolute. The three parts are built together (48 words a
// thread); beside the 128 accumulators of DHP 256 that takes 255 registers
// and spills nothing (building, issuing and waiting on one part at a time
// spilled there, and took more registers at DHP 192). The strided
// [B, S, H, dh] view of the model is read in place through the tensor
// maps' strides; the output is stored from registers. An operand no tensor
// map takes (a base off a 16-byte boundary, or a stride that is not whole
// 16-byte units) is first copied by the pack pass (split_kernel<bf16, 1>)
// into a contiguous [B, H, S, dhp] buffer, dhp = dh rounded up to 8, the
// columns past dh zero; only such operands are packed, and the attention
// kernel is the same. Bound of the pack: bytes, each element read once and
// written once.
//
// Split route (split_kernel<float, 3>, then flash_wgmma_kernel<DHP, 3>;
// float32, dh <= 256, any view with dh contiguous). TF32 would miss the
// 2e-5 f32 limit, and its wgmma takes B only K-major, so V would need a
// transpose. Instead one pass writes each of q, k and v as three bf16
// parts (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid); hi +
// mid + lo is x to its last bit for normal x) into a contiguous [3, B, H,
// S, dhp] buffer, K and V once a KV head, reading x through its strides;
// the attention kernel then reads the parts as batches p * B + b of the
// same tensor maps. S = sum of Q_a K_b^T and O += sum of P_a V_b over the
// six part pairs a + b <= 2, smallest first (the dropped ones are at most
// about 2^-24 of the product; each bf16 product is exact in the f32
// accumulator). Three parts of Q, K and V at 64 keys a tile would need 240
// KB at DHP 128, so K/V tiles are 32 keys there: two warpgroups' Q parts
// (96 KB) and two stages (96 KB) fit one 8-warp block an SM; DHP 64 is one
// warpgroup a block. Above DHP 128 a block is one warpgroup (232,448 bytes
// a block at most): on 32-key tiles at DHP 192 (72 KB of Q parts, 144 KB
// of stages; two warpgroups on 16-key tiles fit as well, but their
// m64n16k16 S products ran slower), on 16-key tiles at DHP 256 (S on
// m64n16k16, 2 KB TMA boxes: two whole swizzle atoms; 96 KB and 96 KB).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

// 0: this library's attention kernels take no cap (softcap 0). 1: they
// all apply one (flash_attention_softcap.cu, which includes this file: its
// own library, built beside this one, so that the capped instantiations
// add nothing to this file's build time); there the split and pack passes
// are left out, since the capped route calls this library's.
#ifndef FLASH_SOFTCAP
#define FLASH_SOFTCAP 0
#endif

namespace {
namespace tc {

constexpr int THREADS = 128;      // one warpgroup
constexpr int BM = 64;            // query rows a warpgroup
constexpr int STAGES = 2;         // K/V ring depth
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of the tensor map at coordinates (c0..c3) into shared memory,
// completing on ``bar``
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A tensor map's outer coordinates are (row, head, batch) in the order of
// their strides; ``perm`` holds the slot (1..3) of each, 2 bits apiece.
__device__ __forceinline__ void tma_box(const CUtensorMap* map, int perm,
                                        uint32_t dst, uint32_t bar, int col,
                                        int row, int head, int batch) {
  const int ps = perm & 3, ph = (perm >> 2) & 3;
  const int c1 = ps == 1 ? row : (ph == 1 ? head : batch);
  const int c2 = ps == 2 ? row : (ph == 2 ? head : batch);
  const int c3 = ps == 3 ? row : (ph == 3 ? head : batch);
  tma_load_4d(dst, map, bar, col, c1, c2, c3);
}

// One tensor-core instantiation: head dim padded to DHP, and PARTS 1 (bf16
// in and out) or 3 (the split route: f32 in and out, each operand as three
// bf16 parts). A tile row is NB boxes of 64 columns (128 bytes); the parts
// of a tile follow one another, part p of a box g at p * NB + g boxes.
template <int DHP_, int PARTS_>
struct Tile {
  static constexpr int DHP = DHP_, PARTS = PARTS_;
  // keys a K/V tile: 64 on the bf16 route; on the split route, whose three
  // parts of Q, K and V would need 240 KB at 64 keys and DHP 128, 32 up to
  // DHP 192 and 16 at 256
  static constexpr int BN = PARTS == 1 ? 64 : DHP <= 192 ? 32 : 16;
  // warpgroups a block: two share each K/V stage where one warpgroup's Q
  // and ring would leave one 4-warp block an SM (bf16 above DHP 128, the
  // split route at DHP 128). The split route's DHP 192 keeps one
  // warpgroup on 32-key tiles: two on 16-key tiles fit too, but ran
  // slower on an H100 (their S products are m64n16k16); at DHP 256 two
  // warpgroups do not fit (295,960 bytes)
  static constexpr int NWG =
      PARTS == 1 ? (DHP > 128 ? 2 : 1) : (DHP == 128 ? 2 : 1);
  static constexpr int NB = (DHP + 63) / 64;
  static constexpr int QBOX = BM * 128, KBOX = BN * 128;  // bytes of a box
  static constexpr int QPART = NB * QBOX, KPART = NB * KBOX;
  static constexpr int QTILE = PARTS * QPART;  // a warpgroup's Q
  static constexpr int KTILE = PARTS * KPART;  // one stage's K (or V)
  // dynamic shared memory: NWG Q tiles, STAGES K and V tiles, the
  // mbarriers, and 1 KB to align the swizzled tiles
  static constexpr size_t SMEM = 1024 + (size_t)NWG * QTILE +
                                 (size_t)2 * STAGES * KTILE + 8 * (STAGES + 1);
  static_assert(SMEM <= 232448, "more shared memory than a block may take");
  using Out =
      typename std::conditional<PARTS == 3, float, __nv_bfloat16>::type;
};

// The part pairs (a, b) of a product of two split operands, a + b <= 2,
// smallest first: (2,0) (1,1) (0,2) (1,0) (0,1) (0,0). The dropped pairs
// are at most about 2^-24 of the product.
__host__ __device__ constexpr int pair_a(int n) {
  return n == 0 ? 2 : n == 1 || n == 3 ? 1 : 0;
}
__host__ __device__ constexpr int pair_b(int n) {
  return n == 2 ? 2 : n == 1 || n == 4 ? 1 : 0;
}

// the K and V tiles of T::BN rows from ``row``, every part's NB boxes,
// into shared memory at k_dst / v_dst, completing on ``bar`` (one thread);
// part p of batch ``batch`` is batch p * nb + batch of the tensor maps
template <typename T>
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, int kperm,
                                        int vperm, uint32_t k_dst,
                                        uint32_t v_dst, uint32_t bar, int row,
                                        int head, int batch, int nb) {
  mbar_expect_tx(bar, 2 * T::KTILE);
#pragma unroll 1
  for (int p = 0; p < T::PARTS; ++p)
    for (int g = 0; g < T::NB; ++g) {
      const uint32_t off = p * T::KPART + g * T::KBOX;
      tma_box(kmap, kperm, k_dst + off, bar, g * 64, row, head,
              p * nb + batch);
      tma_box(vmap, vperm, v_dst + off, bar, g * 64, row, head,
              p * nb + batch);
    }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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
// keep the compiler from moving register reads and writes across the
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<64> {
  // d[64 x 64] (+)= a[64 x 16] . b[16 x 64], both K-major in shared memory;
  // ``accumulate`` 0 overwrites d
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaSS<32> {
  // d[64 x 32] (+)= a[64 x 16] . b[16 x 32], both K-major in shared memory;
  // ``accumulate`` 0 overwrites d
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaSS<16> {
  // d[64 x 16] (+)= a[64 x 16] . b[16 x 16], both K-major in shared memory;
  // ``accumulate`` 0 overwrites d
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  // d[64 x 64] (+)= a[64 x 16] (registers) . b[16 x 64] (MN-major);
  // ``accumulate`` 0 overwrites d
  static __device__ __forceinline__ void mma(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaRS<80> {
  // d[64 x 80] (+)= a[64 x 16] (registers) . b[16 x 80] (MN-major);
  // ``accumulate`` 0 overwrites d
  static __device__ __forceinline__ void mma(float (&d)[40], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaRS<128> {
  // d[64 x 128] (+)= a[64 x 16] (registers) . b[16 x 128] (MN-major);
  // ``accumulate`` 0 overwrites d
  static __device__ __forceinline__ void mma(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaRS<160> {
  // d[64 x 160] (+)= a[64 x 16] (registers) . b[16 x 160] (MN-major: two
  // whole boxes and half of a third); ``accumulate`` 0 overwrites d
  static __device__ __forceinline__ void mma(float (&d)[80], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaRS<192> {
  // d[64 x 192] (+)= a[64 x 16] (registers) . b[16 x 192] (MN-major: three
  // whole boxes); ``accumulate`` 0 overwrites d
  static __device__ __forceinline__ void mma(float (&d)[96], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaRS<256> {
  // d[64 x 256] (+)= a[64 x 16] (registers) . b[16 x 256] (MN-major: four
  // whole boxes); ``accumulate`` 0 overwrites d
  static __device__ __forceinline__ void mma(float (&d)[128], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
  }
};


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the bf16 parts of two scores: ``part`` 0 is hi = bf16(x), 1 is mid =
// bf16(x - hi), 2 is lo = bf16(x - hi - mid) (both differences are exact in
// f32), packed as one A-fragment register
__device__ __forceinline__ uint32_t p_part(float x0, float x1, int part) {
  float x[2] = {x0, x1}, y[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    y[e] = __bfloat162float(__float2bfloat16(x[e]));
    if (part > 0) {
      x[e] -= y[e];
      y[e] = __bfloat162float(__float2bfloat16(x[e]));
      if (part > 1) y[e] = x[e] - y[e];
    }
  }
  return pack_bf16(y[0], y[1]);
}

// The key tiles [begin, end) of BN keys that query rows first..last reach
template <int BN>
__device__ __forceinline__ void tile_range(int first, int last, int Sk,
                                           int causal, int window,
                                           int q_offset, int& begin,
                                           int& end) {
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, last + q_offset + 1);
  if (window) k_begin = max(0, first + q_offset - window + 1);
  begin = k_begin / BN;
  end = k_end > k_begin && last >= first ? (k_end + BN - 1) / BN : begin;
}

// Shared memory (box g of part p of a tile at (p * NB + g) boxes, row r of
// a box at r * 128 with its 16-byte chunks swizzled by r % 8): NWG Q tiles
// (one a warpgroup), then STAGES K tiles, then STAGES V tiles, then the
// mbarriers (Q's, then one per stage). Warpgroup w owns query rows
// q0 + 64 w .. q0 + 64 w + 63 and computes only the tiles its own rows
// reach; the block loads the tiles any of its rows reach, and every thread
// meets every stage's release, so a warpgroup whose rows are all masked
// (or past Sq) still keeps the ring turning. ``nb`` is the batch count:
// part p of batch b is batch p * nb + b of the tensor maps. CAP applies
// the soft-cap (``softcap`` > 0) to each scaled score; the cap-free
// instantiations (CAP false) compile as if it were not there.
template <int DHP, int PARTS, bool CAP>
__global__ void __launch_bounds__(THREADS * Tile<DHP, PARTS>::NWG,
                                  Tile<DHP, PARTS>::NWG == 1 ? 2 : 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, int qperm,
                   int kperm, int vperm,
                   typename Tile<DHP, PARTS>::Out* __restrict__ o,
                   long long osb, long long osh, long long oss, int G,
                   int nb, int Sq, int Sk, int dh, int causal, int window,
                   int q_offset, float sm_scale, float softcap) {
  using T = Tile<DHP, PARTS>;
  constexpr int NWG = T::NWG, BN = T::BN, NB = T::NB;
  constexpr int NO = DHP / 2;   // O fragment, floats a thread
  constexpr int NS = BN / 2;    // S fragment, floats a thread
  constexpr int NP = BN / 4;    // one P part, A-fragment registers a thread
  // products of S = Q K^T: pairs 6 - NSP .. 5 of pair_a / pair_b
  constexpr int NSP = PARTS == 3 ? 6 : 1;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + NWG * T::QTILE, sV = sK + STAGES * T::KTILE;
  // then full[s] = q_bar + 8 (1 + s)
  const uint32_t q_bar = sV + STAGES * T::KTILE;

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = NWG == 1 ? 0 : tid >> 7, warp = (tid >> 5) & 3;
  // longest rows first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM * NWG;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int n_q = min(NWG, (Sq - q0 + BM - 1) / BM);  // Q tiles inside Sq

  // the key tiles the block's rows reach, and those of this warpgroup's
  int t_begin, t_end;
  tile_range<BN>(q0, min(q0 + BM * NWG, Sq) - 1, Sk, causal, window,
                 q_offset, t_begin, t_end);
  const int n_t = t_end - t_begin;
  const int wq0 = q0 + wg * BM, wq_last = min(wq0 + BM, Sq) - 1;
  int w_begin = t_begin, w_end = t_end;
  if (NWG > 1)
    tile_range<BN>(wq0, wq_last, Sk, causal, window, q_offset, w_begin,
                   w_end);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= STAGES; ++s) mbar_init(q_bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_t > 0) {
    mbar_expect_tx(q_bar, n_q * T::QTILE);
#pragma unroll 1
    for (int w = 0; w < n_q; ++w)
      for (int p = 0; p < PARTS; ++p)
        for (int g = 0; g < NB; ++g)
          tma_box(&qmap, qperm,
                  sQ + w * T::QTILE + p * T::QPART + g * T::QBOX, q_bar,
                  g * 64, q0 + w * BM, h, p * nb + b);
    for (int s = 0; s < STAGES && s < n_t; ++s)
      load_kv<T>(&kmap, &vmap, kperm, vperm, sK + s * T::KTILE,
                 sV + s * T::KTILE, q_bar + 8 * (1 + s), (t_begin + s) * BN,
                 hk, b, nb);
  }

  // this thread's rows of the warpgroup's tile: r0 and r0 + 8
  const uint32_t wQ = sQ + wg * T::QTILE;
  const int r0 = warp * 16 + (lane >> 2);
  const int qp0 = wq0 + r0 + q_offset, qp1 = qp0 + 8;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float inv_cap = CAP ? 1.f / softcap : 0.f;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  if (w_end > w_begin) mbar_wait(q_bar, 0);
#pragma unroll 1
  for (int i = 0; i < n_t; ++i) {
    const int t = t_begin + i, stage = i % STAGES;
    const uint32_t kt = sK + stage * T::KTILE, vt = sV + stage * T::KTILE;
    if (NWG == 1 || (t >= w_begin && t < w_end)) {
      mbar_wait(q_bar + 8 * (1 + stage), (i / STAGES) & 1);

      // S = Q . K^T (on the split route the sum of six part products,
      // smallest first), K-major operands: a k-step of 16 columns starts 32
      // bytes into a 128-byte row (a box further every 4 steps); 8-row
      // groups 1 KB apart
      float s[NS] = {};
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int n = 6 - NSP; n < 6; ++n)
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk)
          WgmmaSS<BN>::mma(
              s,
              desc(wQ + pair_a(n) * T::QPART + (kk >> 2) * T::QBOX +
                       (kk & 3) * 32,
                   16, 1024),
              desc(kt + pair_b(n) * T::KPART + (kk >> 2) * T::KBOX +
                       (kk & 3) * 32,
                   16, 1024),
              n > 6 - NSP || kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // s[j]: row r0 + 8 * ((j >> 1) & 1), key k0 + 8 * (j >> 2) +
      // 2 * (lane & 3) + (j & 1)
      const int k0 = t * BN;
      const bool whole = k0 + BN <= Sk &&
                         (!causal || k0 + BN - 1 <= wq0 + q_offset) &&
                         (!window || k0 > wq_last + q_offset - window);
      float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float x = s[j] * sm_scale;
        // tanhf, not tanh.approx.f32 (2^-11 relative): the split route's
        // 2e-5 limit holds the capped scores too
        if constexpr (CAP) x = tanhf(x * inv_cap) * softcap;
        if (!whole) {
          const int kp = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
          const int qp = (j & 2) ? qp1 : qp0;
          const bool in = kp < Sk && (!causal || kp <= qp) &&
                          (!window || kp > qp - window);
          x = in ? x : NEG_INF;
        }
        s[j] = x;
        mt[(j >> 1) & 1] = fmaxf(mt[(j >> 1) & 1], x);
      }
      float m_safe[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
        m_safe[r] = m_new <= NEG_INF / 2 ? 0.f : m_new;
        corr[r] = m[r] <= NEG_INF / 2 ? 0.f : expf(m[r] - m_safe[r]);
        m[r] = m_new;
      }
      // p: a masked score is -1e30, whose expf is exactly 0
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int r = (j >> 1) & 1;
        s[j] = expf(s[j] - m_safe[r]);
        psum[r] += s[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l[r] = l[r] * corr[r] + psum[r];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[j] *= corr[(j >> 1) & 1];

      // O += P . V with P = P_hi + P_mid + P_lo (parts 0, 1, 2 of p_part)
      // as A fragments: keys 16 kc .. 16 kc + 15 are s[8 kc .. 8 kc + 7],
      // i.e. registers 4 kc .. 4 kc + 3 of a part. V is the MN-major B
      // operand: a k-step of 16 keys starts 16 rows (2 KB) further, 8-key
      // groups 1 KB apart, 64-column boxes KBOX apart. On the split route
      // the sum of P_a V_b over the six pairs of pair_a / pair_b, else over
      // (2,0) (1,0) (0,0); the smallest terms first.
      uint32_t pw[3][NP];
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int j = 0; j < NP; ++j)
          pw[part][j] = p_part(s[2 * j], s[2 * j + 1], part);
#pragma unroll
      for (int part = 0; part < 3; ++part) fence_regs(pw[part]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
        for (int n = 0; n < (PARTS == 3 ? 6 : 3); ++n) {
          const int a = PARTS == 3 ? pair_a(n) : 2 - n;
          const int bv = PARTS == 3 ? pair_b(n) : 0;
          WgmmaRS<DHP>::mma(
              acc, pw[a][4 * kc], pw[a][4 * kc + 1], pw[a][4 * kc + 2],
              pw[a][4 * kc + 3],
              desc(vt + bv * T::KPART + kc * 16 * 128, T::KBOX, 1024), 1);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int part = 0; part < 3; ++part) fence_regs(pw[part]);
    }

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && i + STAGES < n_t)
      load_kv<T>(&kmap, &vmap, kperm, vperm, kt, vt, q_bar + 8 * (1 + stage),
                 (t + STAGES) * BN, hk, b, nb);
  }

  // acc[j]: row r0 + 8 * ((j >> 1) & 1), column 8 * (j >> 2) +
  // 2 * (lane & 3) + (j & 1)
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  typename T::Out* ob = o + b * osb + h * osh;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int r = (j >> 1) & 1;
    const int qr = wq0 + r0 + 8 * r;
    const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
    if (qr < Sq && col < dh)
      store(ob + (long long)qr * oss + col, acc[j] * inv[r]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, through the runtime (no
// -lcuda)
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 [B, H, S, dh] view (element strides sb, sh, ss; dh contiguous) as
// a 4-D tensor map whose box is 64 columns x ``rows`` rows, 128-byte
// swizzled. The outer dims go in the order of their strides, size-1 dims
// last with a stride that only has to be valid; ``perm`` gets each one's
// slot (see tma_box). Reads past dh, S, H or B are zero-filled.
bool encode_bhsd(CUtensorMap* map, const void* base, int B, int H, int S,
                 int dh, long long sb, long long sh, long long ss, int rows,
                 int* perm) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  long long n[3] = {S, H, B}, st[3] = {ss, sh, sb};
  int order[3] = {0, 1, 2};
  auto key = [&](int i) { return n[i] == 1 ? (1LL << 62) : st[i]; };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && key(order[j]) < key(order[j - 1]); --j) {
      const int x = order[j];
      order[j] = order[j - 1];
      order[j - 1] = x;
    }
  cuuint64_t dims[4] = {(cuuint64_t)dh, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estr[4] = {1, 1, 1, 1};
  long long span = (dh + 7) / 8 * 8;  // elements one step of the last dim spans
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    const int which = order[i];
    const long long stride = n[which] == 1 ? span : st[which];
    dims[i + 1] = (cuuint64_t)n[which];
    strides[i] = (cuuint64_t)stride * 2;
    span = (stride * n[which] + 7) / 8 * 8;
    if (which == 0) box[i + 1] = rows;
    *perm |= (i + 1) << (2 * which);
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The DHP / PARTS / CAP instantiation on bf16 views q, k, v (on the split
// route the [PARTS * B, H, S, dh] views of the parts, batch p * B + b part
// p of batch b). Returns cudaErrorInvalidValue where a tensor map is
// refused.
template <int DHP, int PARTS, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int dh, int causal,
           const long long* st, int window, int q_offset, float sm_scale,
           float softcap, cudaStream_t stream) {
  using T = Tile<DHP, PARTS>;
  CUtensorMap qm, km, vm;
  int qp, kp, vp;
  if (!encode_bhsd(&qm, q, PARTS * B, Hq, Sq, dh, st[0], st[1], st[2], BM,
                   &qp) ||
      !encode_bhsd(&km, k, PARTS * B, Hkv, Sk, dh, st[3], st[4], st[5],
                   T::BN, &kp) ||
      !encode_bhsd(&vm, v, PARTS * B, Hkv, Sk, dh, st[6], st[7], st[8],
                   T::BN, &vp))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<DHP, PARTS, CAP>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)T::SMEM);
  const dim3 grid((Sq + BM * T::NWG - 1) / (BM * T::NWG), Hq, B);
  kern<<<grid, THREADS * T::NWG, T::SMEM, stream>>>(
      qm, km, vm, qp, kp, vp, (typename T::Out*)o, st[9], st[10], st[11],
      Hq / Hkv, B, Sq, Sk, dh, causal, window, q_offset, sm_scale, softcap);
  return (int)cudaGetLastError();
}

// Resources of the DHP / PARTS / CAP instantiation into out (see
// flash_attention_wgmma_resources)
template <int DHP, int PARTS, bool CAP>
int resources(int* out) {
  using T = Tile<DHP, PARTS>;
  const void* fn = (const void*)flash_wgmma_kernel<DHP, PARTS, CAP>;
  const int threads = THREADS * T::NWG;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      T::SMEM);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)T::SMEM;
  out[3] = threads;
  out[4] = blocks;
  return (int)cudaSuccess;
}

// x [B, H, S, dh] (element strides sb, sh, ss; dh contiguous) into PARTS
// bf16 parts, out [PARTS][B][H][S][dhp] contiguous, columns dh .. dhp - 1
// zero. Part 0 is bf16(x) and part p the bf16 of what parts 0 .. p - 1
// leave of x (each difference exact in f32): f32 in with 3 parts is the
// split route's pass (hi, mid, lo), bf16 in with 1 part the pack, a plain
// copy into rows of whole 16-byte units. One warp a row, its lanes on
// neighbouring columns.
constexpr int SPLIT_WARPS = 8;
template <typename In, int PARTS>
__global__ void __launch_bounds__(32 * SPLIT_WARPS)
split_kernel(const In* __restrict__ x, __nv_bfloat16* __restrict__ out,
             int rows, int H, int S, int dh, int dhp, long long sb,
             long long sh, long long ss) {
  static_assert(std::is_same<In, float>::value == (PARTS == 3),
                "f32 splits into 3 parts, bf16 packs into 1");
  const int row = blockIdx.x * SPLIT_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int s = row % S, bh = row / S;
  const In* xr = x + (bh / H) * sb + (bh % H) * sh + s * ss;
  __nv_bfloat16* dst = out + (long long)row * dhp;
  for (int d = threadIdx.x & 31; d < dhp; d += 32) {
    if constexpr (PARTS == 1) {
      dst[d] = d < dh ? xr[d] : __float2bfloat16(0.f);
    } else {
      float r = d < dh ? xr[d] : 0.f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {   // part p at p * rows * dhp
        const __nv_bfloat16 y = __float2bfloat16(r);
        dst[(long long)p * rows * dhp + d] = y;
        r -= __bfloat162float(y);
      }
    }
  }
}

// split_kernel<In, PARTS> over x [B, H, S, dh] into out (see
// split_bf16x3_launch); returns a cudaError_t
template <typename In, int PARTS>
int split_launch(const void* x, void* out, int B, int H, int S, int dh,
                 int dhp, long long sb, long long sh, long long ss,
                 cudaStream_t stream) {
  const long long rows = (long long)B * H * S;
  if (dh <= 0 || dhp < dh || B < 0 || H < 0 || S < 0 || rows > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int grid = (int)((rows + SPLIT_WARPS - 1) / SPLIT_WARPS);
  split_kernel<In, PARTS><<<grid, 32 * SPLIT_WARPS, 0, stream>>>(
      (const In*)x, (__nv_bfloat16*)out, (int)rows, H, S, dh, dhp, sb, sh,
      ss);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// Strides are in elements, (batch, head, sequence) for each of q, k, v, o.
// softcap is 0 in this library and a finite cap > 0 in the soft-capped one
// (FLASH_SOFTCAP). Each entry returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a head dim outside (0, dhp], a dhp no
// instantiation has, query heads that KV heads do not divide, or a
// softcap the library does not take.
#define FLASH_TC_ARGS                                                        \
  const void *q, const void *k, const void *v, void *o, int B, int Hq,       \
      int Hkv, int Sq, int Sk, int dh, int causal, long long q_sb,           \
      long long q_sh, long long q_ss, long long k_sb, long long k_sh,        \
      long long k_ss, long long v_sb, long long v_sh, long long v_ss,        \
      long long o_sb, long long o_sh, long long o_ss, int window,            \
      int q_offset, float sm_scale, float softcap, int dhp, void *stream
#define FLASH_TC(D, P)                                                       \
  return tc::launch<D, P, FLASH_SOFTCAP>(q, k, v, o, B, Hq, Hkv, Sq, Sk, dh, \
                                         causal, st, window, q_offset,       \
                                         sm_scale, softcap,                  \
                                         (cudaStream_t)stream)
#define FLASH_TC_STRIDES                                                     \
  if (dh <= 0 || dh > dhp || Hkv <= 0 || Hq % Hkv ||                         \
      !(FLASH_SOFTCAP ? softcap > 0.f && softcap <= 3.4e38f                  \
                      : softcap == 0.f))                                     \
    return (int)cudaErrorInvalidValue;                                       \
  if (B <= 0 || Hq <= 0 || Sq <= 0) return (int)cudaSuccess;                 \
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,              \
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss}

// The bf16 route: bf16 q, k, v, o, 0 < dh <= dhp, dhp the padded head dim
// of an instantiation (64, 80, 128, 160, 192 or 256; the wrapper picks
// it), every base of q, k, v 16-byte aligned and every stride of a dim
// longer than 1 a multiple of 8 elements (the wrapper packs an operand
// that is not; a tensor map cuTensorMapEncodeTiled refuses returns
// cudaErrorInvalidValue); o through its own strides.
extern "C" int flash_attention_wgmma_launch(FLASH_TC_ARGS) {
  FLASH_TC_STRIDES;
  switch (dhp) {
    case 64: FLASH_TC(64, 1);
    case 80: FLASH_TC(80, 1);
    case 128: FLASH_TC(128, 1);
    case 160: FLASH_TC(160, 1);
    case 192: FLASH_TC(192, 1);
    case 256: FLASH_TC(256, 1);
  }
  return (int)cudaErrorInvalidValue;
}

// The split route: f32 attention on the tensor cores. q, k, v are the
// [3 B, H, S, dh] bf16 views of split_bf16x3_launch's parts (batch p * B +
// b is part p of batch b; strides of those views), o the f32 output; dhp
// 64, 128, 192 or 256. Other arguments as flash_attention_wgmma_launch's.
extern "C" int flash_attention_split_f32_launch(FLASH_TC_ARGS) {
  FLASH_TC_STRIDES;
  switch (dhp) {
    case 64: FLASH_TC(64, 3);
    case 128: FLASH_TC(128, 3);
    case 192: FLASH_TC(192, 3);
    case 256: FLASH_TC(256, 3);
  }
  return (int)cudaErrorInvalidValue;
}
#undef FLASH_TC_ARGS
#undef FLASH_TC
#undef FLASH_TC_STRIDES

#if !FLASH_SOFTCAP

// x [B, H, S, dh] f32 (element strides sb, sh, ss; dh contiguous) into out,
// a contiguous [3, B, H, S, dhp] bf16 buffer (dhp >= dh): its hi, mid and lo
// parts, columns past dh zero. Returns a cudaError_t.
extern "C" int split_bf16x3_launch(const void* x, void* out, int B, int H,
                                   int S, int dh, int dhp, long long sb,
                                   long long sh, long long ss, void* stream) {
  return tc::split_launch<float, 3>(x, out, B, H, S, dh, dhp, sb, sh, ss,
                                    (cudaStream_t)stream);
}

// x [B, H, S, dh] bf16 (element strides sb, sh, ss; dh contiguous) copied
// into out, a contiguous [B, H, S, dhp] bf16 buffer (dhp >= dh), columns past
// dh zero. Returns a cudaError_t.
extern "C" int pack_bf16_launch(const void* x, void* out, int B, int H, int S,
                                int dh, int dhp, long long sb, long long sh,
                                long long ss, void* stream) {
  return tc::split_launch<__nv_bfloat16, 1>(x, out, B, H, S, dh, dhp, sb, sh,
                                            ss, (cudaStream_t)stream);
}

#endif  // !FLASH_SOFTCAP

// Resources of the tensor-core instantiation of padded head dim ``dhp``
// (the bf16 route's 64, 80, 128, 160, 192, 256 with f32 0; the split
// route's 64, 128, 192, 256 with f32 1): out[0] registers a thread,
// out[1] local (spill) bytes a thread, out[2] dynamic shared bytes a
// block, out[3] threads a block, out[4] blocks resident an SM. Returns a
// cudaError_t.
extern "C" int flash_attention_wgmma_resources(int dhp, int f32, int* out) {
  if (f32) {
    switch (dhp) {
      case 64: return tc::resources<64, 3, FLASH_SOFTCAP>(out);
      case 128: return tc::resources<128, 3, FLASH_SOFTCAP>(out);
      case 192: return tc::resources<192, 3, FLASH_SOFTCAP>(out);
      case 256: return tc::resources<256, 3, FLASH_SOFTCAP>(out);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (dhp) {
    case 64: return tc::resources<64, 1, FLASH_SOFTCAP>(out);
    case 80: return tc::resources<80, 1, FLASH_SOFTCAP>(out);
    case 128: return tc::resources<128, 1, FLASH_SOFTCAP>(out);
    case 160: return tc::resources<160, 1, FLASH_SOFTCAP>(out);
    case 192: return tc::resources<192, 1, FLASH_SOFTCAP>(out);
    case 256: return tc::resources<256, 1, FLASH_SOFTCAP>(out);
  }
  return (int)cudaErrorInvalidValue;
}
