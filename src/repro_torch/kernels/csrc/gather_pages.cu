// Page gather for Hopper: out[k, :] = pool[clamp(idx[k], 0, n_pages-1), :].
//
// Replaces the Pallas TPU kernels gather_pages_fwd (_gather_kernel) and
// gather_pages_async_fwd (_gather_async_kernel) of
// src/repro/kernels/gather_pages/kernel.py.
//
// Both kernels copy raw bytes, so one kernel serves every dtype. A row is
// `row_bytes` long; when the row length and both bases are 16-byte aligned
// the copy moves 16-byte pieces, otherwise single bytes.
//
// Bound: memory. The work reads K rows and writes K rows, 2*K*row_bytes
// bytes. At the serving path's widths a row is one KV page (16 tokens x 2 KV
// heads x 128 dims x bf16 = 8 KB) and K is 48 to 96, so a call moves under
// 2 MB: well under a microsecond at 3.35 TB/s, so launch latency and the
// wrapper's host work set the time.
//
// gather_pages_kernel: grid (K, tiles); each block copies one TILE-byte
// tile of one row, straight from device memory to device memory.
//
// gather_pages_async_kernel: the issue/wait form, on Hopper's bulk
// asynchronous copies. A block of one warp owns `per_block` consecutive
// (row, tile) items and one elected thread moves them: it issues every
// item's global -> shared `cp.async.bulk` (each completing on its own
// mbarrier with the item's byte count) before it waits on the first, then
// for each item in turn waits and issues the shared -> global bulk copy.
// The copy of item k+1 is thus in flight before the wait on item k, the
// TPU kernel's contract, and the grid is sized so that every item of the
// call is in flight at once (at most `per_block` items a block, items
// spread over the SMs). Rows that are not 16-byte aligned take the sync
// kernel's byte path. The bytes equal gather_pages_kernel's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long TILE = 8192;          // bytes per (row, tile) item
constexpr int MAX_PER_BLOCK = 4;          // items a block of the async kernel

__device__ __forceinline__ long long clamp_row(const int* idx, int k,
                                               int n_pages) {
  int p = idx[k];
  p = p < 0 ? 0 : (p >= n_pages ? n_pages - 1 : p);
  return (long long)p;
}

__global__ void gather_pages_kernel(const uint8_t* __restrict__ pool,
                                    const int* __restrict__ idx,
                                    uint8_t* __restrict__ out, int n_pages,
                                    long long row_bytes, int vec) {
  const int k = blockIdx.x;
  const long long t0 = (long long)blockIdx.y * TILE;
  const long long t1 = t0 + TILE < row_bytes ? t0 + TILE : row_bytes;
  const uint8_t* src = pool + clamp_row(idx, k, n_pages) * row_bytes;
  uint8_t* dst = out + (long long)k * row_bytes;
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src + t0);
    int4* d4 = reinterpret_cast<int4*>(dst + t0);
    const long long n4 = (t1 - t0) / 16;
    for (long long i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (long long i = t0 + threadIdx.x; i < t1; i += blockDim.x)
      dst[i] = src[i];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__global__ void gather_pages_async_kernel(const uint8_t* __restrict__ pool,
                                          const int* __restrict__ idx,
                                          uint8_t* __restrict__ out,
                                          int n_pages, long long row_bytes,
                                          int n_tiles, long long n_items,
                                          int per_block) {
  extern __shared__ __align__(128) uint8_t ring[];  // per_block x TILE
  __shared__ __align__(8) uint64_t bars[MAX_PER_BLOCK];
  const long long first = (long long)blockIdx.x * per_block;
  const long long left = n_items - first;
  const int n = left < per_block ? (int)left : per_block;
  if (threadIdx.x != 0 || n <= 0) return;

  auto item = [&](int i, const uint8_t** src, uint8_t** dst) {
    const long long it = first + i;
    const int k = (int)(it / n_tiles);
    const long long t0 = (it % n_tiles) * TILE;
    *src = pool + clamp_row(idx, k, n_pages) * row_bytes + t0;
    *dst = out + (long long)k * row_bytes + t0;
    return (uint32_t)(t0 + TILE < row_bytes ? TILE : row_bytes - t0);
  };

  for (int i = 0; i < n; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(&bars[i]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // issue every load ...
  for (int i = 0; i < n; ++i) {
    const uint8_t* src;
    uint8_t* dst;
    const uint32_t bytes = item(i, &src, &dst);
    const uint32_t bar = smem_u32(&bars[i]);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring + i * TILE)),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  }
  // ... then wait on each in turn and write it out
  for (int i = 0; i < n; ++i) {
    const uint8_t* src;
    uint8_t* dst;
    const uint32_t bytes = item(i, &src, &dst);
    asm volatile(
        "{\n.reg .pred P1;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
        "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(&bars[i]))
        : "memory");
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst),
        "r"(smem_u32(ring + i * TILE)), "r"(bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  // the stores have read shared memory: the block may leave
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

}  // namespace

// 16-byte pieces when the row length and both bases allow them
static int aligned16(const void* pool, const void* out, long long row_bytes) {
  return (((uintptr_t)pool | (uintptr_t)out | (uintptr_t)row_bytes) & 15) == 0;
}

static int launch_sync(const void* pool, const void* idx, void* out,
                       int n_pages, int K, long long row_bytes, int vec,
                       cudaStream_t stream) {
  const int n_tiles = (int)((row_bytes + TILE - 1) / TILE);
  dim3 grid(K, n_tiles);
  gather_pages_kernel<<<grid, THREADS, 0, stream>>>(
      (const uint8_t*)pool, (const int*)idx, (uint8_t*)out, n_pages,
      row_bytes, vec);
  return (int)cudaGetLastError();
}

extern "C" int gather_pages_launch(const void* pool, const void* idx,
                                   void* out, int n_pages, int K,
                                   long long row_bytes, void* stream) {
  if (K <= 0 || row_bytes <= 0) return (int)cudaSuccess;
  return launch_sync(pool, idx, out, n_pages, K, row_bytes,
                     aligned16(pool, out, row_bytes), (cudaStream_t)stream);
}

extern "C" int gather_pages_async_launch(const void* pool, const void* idx,
                                         void* out, int n_pages, int K,
                                         long long row_bytes, void* stream) {
  if (K <= 0 || row_bytes <= 0) return (int)cudaSuccess;
  if (!aligned16(pool, out, row_bytes))  // the sync kernel's byte path
    return launch_sync(pool, idx, out, n_pages, K, row_bytes, 0,
                       (cudaStream_t)stream);
  const int n_tiles = (int)((row_bytes + TILE - 1) / TILE);
  const long long n_items = (long long)K * n_tiles;
  const long long sms = sm_count();
  long long per_block = (n_items + sms - 1) / sms;
  if (per_block > MAX_PER_BLOCK) per_block = MAX_PER_BLOCK;
  const long long blocks = (n_items + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_pages_async_kernel<<<(unsigned)blocks, 32, per_block * TILE,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)pool, (const int*)idx, (uint8_t*)out, n_pages,
      row_bytes, n_tiles, n_items, (int)per_block);
  return (int)cudaGetLastError();
}
