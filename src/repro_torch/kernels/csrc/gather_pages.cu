// Page gather for Hopper: out[k, :] = pool[clamp(idx[k], 0, n_pages-1), :].
//
// Replaces the Pallas TPU kernels gather_pages_fwd (_gather_kernel) and
// gather_pages_async_fwd (_gather_async_kernel) of
// src/repro/kernels/gather_pages/kernel.py.
//
// Both kernels copy raw bytes, so one kernel serves every dtype. A row is
// `row_bytes` long; when the wrapper reports 16-byte alignment (`vec`) the
// copy moves 16-byte vectors, otherwise single bytes.
//
// Bound: memory. The work reads K rows and writes K rows, 2*K*row_bytes
// bytes. At the serving path's widths a row is one KV page (16 tokens x 2 KV
// heads x 128 dims x bf16 = 8 KB) and K is about a hundred, so a call moves
// under 2 MB and is bound by launch latency rather than bandwidth.
//
// gather_pages_kernel: grid (K, tiles); each block copies one TILE-byte
// tile of one row, straight from device memory to device memory.
//
// gather_pages_async_kernel: the issue/wait form. A block walks its share
// of the (row, tile) items through a 2-stage shared-memory ring with
// cp.async: it issues item i+1 into one stage before it waits on item i in
// the other, then writes item i out. Each thread writes back exactly the
// 16-byte pieces it copied in, so its own cp.async wait is the only
// synchronisation a stage needs. The bytes equal gather_pages_kernel's.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long TILE = 8192;          // bytes per (row, tile) item
constexpr int ITEMS_PER_BLOCK = 4;        // ring depth walked per block

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

__global__ void gather_pages_async_kernel(const uint8_t* __restrict__ pool,
                                          const int* __restrict__ idx,
                                          uint8_t* __restrict__ out,
                                          int n_pages, long long row_bytes,
                                          int vec, int n_tiles,
                                          long long n_items) {
  if (!vec) {  // unaligned rows: plain byte copy, same bytes, no ring
    for (long long it = blockIdx.x; it < n_items; it += gridDim.x) {
      const int k = (int)(it / n_tiles);
      const long long t0 = (it % n_tiles) * TILE;
      const long long t1 = t0 + TILE < row_bytes ? t0 + TILE : row_bytes;
      const uint8_t* src = pool + clamp_row(idx, k, n_pages) * row_bytes;
      uint8_t* dst = out + (long long)k * row_bytes;
      for (long long i = t0 + threadIdx.x; i < t1; i += blockDim.x)
        dst[i] = src[i];
    }
    return;
  }
  __shared__ __align__(16) uint8_t ring[2][TILE];

  // issue the cp.async copies of item `it` into stage `buf`
  auto issue = [&](long long it, int buf) {
    const int k = (int)(it / n_tiles);
    const long long t0 = (it % n_tiles) * TILE;
    const long long n = (t0 + TILE < row_bytes ? TILE : row_bytes - t0);
    const uint8_t* src = pool + clamp_row(idx, k, n_pages) * row_bytes + t0;
    for (long long i = (long long)threadIdx.x * 16; i < n;
         i += (long long)blockDim.x * 16)
      __pipeline_memcpy_async(&ring[buf][i], src + i, 16);
    __pipeline_commit();
  };
  // write stage `buf` (item `it`) out: the same pieces this thread issued
  auto drain = [&](long long it, int buf) {
    const int k = (int)(it / n_tiles);
    const long long t0 = (it % n_tiles) * TILE;
    const long long n = (t0 + TILE < row_bytes ? TILE : row_bytes - t0);
    uint8_t* dst = out + (long long)k * row_bytes + t0;
    for (long long i = (long long)threadIdx.x * 16; i < n;
         i += (long long)blockDim.x * 16)
      *reinterpret_cast<int4*>(dst + i) =
          *reinterpret_cast<const int4*>(&ring[buf][i]);
  };

  long long it = blockIdx.x;
  if (it >= n_items) return;
  issue(it, 0);                                   // warm-up: item 0
  for (int j = 0; it < n_items; ++j, it += gridDim.x) {
    const long long nxt = it + gridDim.x;
    if (nxt < n_items) {
      issue(nxt, (j + 1) & 1);                    // issue i+1 ...
      __pipeline_wait_prior(1);                   // ... then wait on i
    } else {
      __pipeline_wait_prior(0);
    }
    drain(it, j & 1);
  }
}

}  // namespace

extern "C" int gather_pages_launch(const void* pool, const void* idx,
                                   void* out, int n_pages, int K,
                                   long long row_bytes, int vec,
                                   void* stream) {
  if (K <= 0 || row_bytes <= 0) return (int)cudaSuccess;
  const int n_tiles = (int)((row_bytes + TILE - 1) / TILE);
  dim3 grid(K, n_tiles);
  gather_pages_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pool, (const int*)idx, (uint8_t*)out, n_pages,
      row_bytes, vec);
  return (int)cudaGetLastError();
}

extern "C" int gather_pages_async_launch(const void* pool, const void* idx,
                                         void* out, int n_pages, int K,
                                         long long row_bytes, int vec,
                                         void* stream) {
  if (K <= 0 || row_bytes <= 0) return (int)cudaSuccess;
  const int n_tiles = (int)((row_bytes + TILE - 1) / TILE);
  const long long n_items = (long long)K * n_tiles;
  long long blocks = (n_items + ITEMS_PER_BLOCK - 1) / ITEMS_PER_BLOCK;
  if (blocks > 65535) blocks = 65535;
  gather_pages_async_kernel<<<(unsigned)blocks, THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)pool, (const int*)idx, (uint8_t*)out, n_pages,
      row_bytes, vec, n_tiles, n_items);
  return (int)cudaGetLastError();
}
