// Paged decode attention for Hopper: one query token per sequence against
// KV pages named by a table, with an f32 online softmax over the pages in
// table order.
//
// Replaces the Pallas TPU kernels paged_attention_fwd (_paged_kernel),
// paged_attention_hot_slots_fwd (_hot_slots_kernel) and
// paged_attention_hot_slots_async_fwd (_hot_slots_async_kernel) of
// src/repro/kernels/paged_attention/kernel.py, and their shared per-page
// update _attend_page.
//
// The three kernels differ only in how they find a page and how its K/V
// tile reaches shared memory:
//   flat (HOT=false): page = pool + pt * page_stride, valid iff 0 <= pt < n
//   hot  (HOT=true):  page = hot + (s * n_slots + slot) * page_stride,
//                     valid iff 0 <= slot < n_slots
//   hot async:        the hot addressing; each valid page's raw K/V tile is
//                     copied with cp.async into a 2-stage ring, the next
//                     valid page issued before the current one is waited on
// Every kernel then widens the tile to f32 and runs the same per-page
// update attend_loaded(), which follows _attend_page op for op: scores in
// f32 against q * sm_scale, masked to -1e30, then m_new, m_safe, p, corr,
// l and acc in that order. The launch shape (one block per (sequence, KV
// head), THREADS threads), the thread mapping and every reduction order
// are shared, so on the same bytes in the same page order the outputs of
// all three are bitwise equal -- the property the serving engine's
// fused-vs-flat pin relies on.
//
// A page that is fully masked (an invalid table entry, or a page wholly
// past the length) is skipped without reading it. That is bit-exact: the
// JAX update then gives corr = 1 (or 0 with acc = l = 0) and p = 0, which
// leaves (m, l, acc) unchanged. All three kernels skip the same pages.
//
// Layout: q [B, Hkv, G, dh]; pages [.., page_size, Hkv, dh]; out like q.
// One block per (b, h); the G query heads of the group are held together.
//
// Bound: memory -- the K/V bytes of the valid tokens plus q and o. One
// block per (sequence, KV head) is 16 blocks on 132 SMs at the serving
// path's shapes, so the kernels are far from that bound; the async copy
// only overlaps one page's load with the previous page's update inside a
// block. Splitting the pages across blocks (flash-decoding) is later work
// and must split all three kernels the same way.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared-memory working set of one block (f32 part).
struct Smem {
  float* q;     // [G, dh]  pre-scaled query
  float* k;     // [page, dh]
  float* v;     // [page, dh]
  float* s;     // [G, page] scores, then p
  float* acc;   // [G, dh]
  float* m;     // [G]
  float* l;     // [G]
  float* corr;  // [G]
};

__host__ __device__ inline size_t f32_floats(int G, int dh, int page_size) {
  return (size_t)2 * G * dh + 2 * (size_t)page_size * dh +
         (size_t)G * page_size + 3 * (size_t)G;
}

__device__ Smem carve(float* base, int G, int dh, int page_size) {
  Smem sm;
  sm.q = base;
  sm.k = sm.q + G * dh;
  sm.v = sm.k + page_size * dh;
  sm.s = sm.v + page_size * dh;
  sm.acc = sm.s + G * page_size;
  sm.m = sm.acc + G * dh;
  sm.l = sm.m + G;
  sm.corr = sm.l + G;
  return sm;
}

// Pre-scaled query, zero accumulator, m = -inf, l = 0.
template <typename T>
__device__ void init_block(const T* __restrict__ q, long long qbase, int G,
                           int dh, float sm_scale, Smem sm) {
  for (int i = threadIdx.x; i < G * dh; i += blockDim.x) {
    sm.q[i] = to_f32(q[qbase + i]) * sm_scale;
    sm.acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    sm.m[g] = NEG_INF;
    sm.l[g] = 0.f;
  }
  __syncthreads();
}

template <typename T>
__device__ void store_out(T* __restrict__ out, long long qbase, int G,
                          int dh, Smem sm) {
  for (int i = threadIdx.x; i < G * dh; i += blockDim.x) {
    store(out + qbase + i, sm.acc[i] / fmaxf(sm.l[i / dh], 1e-30f));
  }
}

// The synchronous load: K/V tiles of KV head h, widened to f32.
// `kp` / `vp` point at the page's first element of K and V.
template <typename T>
__device__ void load_tile(const T* __restrict__ kp, const T* __restrict__ vp,
                          int h, int Hkv, int dh, int page_size, Smem sm) {
  for (int i = threadIdx.x; i < page_size * dh; i += blockDim.x) {
    const int t = i / dh, d = i % dh;
    const long long off = ((long long)t * Hkv + h) * dh + d;
    sm.k[i] = to_f32(kp[off]);
    sm.v[i] = to_f32(vp[off]);
  }
  __syncthreads();
}

// One page's online-softmax update for the G grouped heads (_attend_page),
// over the f32 tiles already in sm.k / sm.v. Ends on a barrier.
__device__ void attend_loaded(int dh, int page_size, int G, int j, int length,
                              Smem sm) {
  const int tid = threadIdx.x;
  // scores s[g, t] = (q[g] * sm_scale) . k[t], masked to NEG_INF
  for (int i = tid; i < G * page_size; i += blockDim.x) {
    const int g = i / page_size, t = i % page_size;
    const float* qg = sm.q + g * dh;
    const float* kt = sm.k + t * dh;
    float dot = 0.f;
    for (int d = 0; d < dh; ++d) dot += qg[d] * kt[d];
    sm.s[i] = j * page_size + t < length ? dot : NEG_INF;
  }
  __syncthreads();
  // per-head statistics in _attend_page's order: m_new, m_safe, p, corr, l
  for (int g = tid; g < G; g += blockDim.x) {
    float* sg = sm.s + g * page_size;
    float mx = NEG_INF;
    for (int t = 0; t < page_size; ++t) mx = fmaxf(mx, sg[t]);
    const float m_prev = sm.m[g];
    const float m_new = fmaxf(m_prev, mx);
    const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
    float psum = 0.f;
    for (int t = 0; t < page_size; ++t) {
      const float p = j * page_size + t < length ? expf(sg[t] - m_safe) : 0.f;
      sg[t] = p;
      psum += p;
    }
    const float corr = m_prev <= NEG_INF / 2 ? 0.f : expf(m_prev - m_safe);
    sm.l[g] = sm.l[g] * corr + psum;
    sm.m[g] = m_new;
    sm.corr[g] = corr;
  }
  __syncthreads();
  // acc[g, d] = acc * corr + sum_t p[g, t] * v[t, d]
  for (int i = tid; i < G * dh; i += blockDim.x) {
    const int g = i / dh, d = i % dh;
    const float* pg = sm.s + g * page_size;
    float pv = 0.f;
    for (int t = 0; t < page_size; ++t) pv += pg[t] * sm.v[t * dh + d];
    sm.acc[i] = sm.acc[i] * sm.corr[g] + pv;
  }
  __syncthreads();
}

template <typename T, bool HOT>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out, int Hkv, int G,
    int dh, int page_size, int npps, int n_valid, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const Smem sm = carve(smem, G, dh, page_size);
  const long long qbase = ((long long)b * Hkv + h) * G * dh;
  init_block(q, qbase, G, dh, sm_scale, sm);

  const int length = lengths[b];
  const long long page_elems = (long long)page_size * Hkv * dh;
  for (int j = 0; j < npps && j * page_size < length; ++j) {
    const int e = table[(long long)b * npps + j];
    if (e < 0 || e >= n_valid) continue;        // masked page: skipped
    // the only difference between these two kernels: where the page lives
    const long long pidx = HOT ? (long long)b * n_valid + e : (long long)e;
    load_tile<T>(k_pool + pidx * page_elems, v_pool + pidx * page_elems, h,
                 Hkv, dh, page_size, sm);
    attend_loaded(dh, page_size, G, j, length, sm);
  }
  store_out(out, qbase, G, dh, sm);
}

// ---- the async hot-slot kernel ---------------------------------------------

// One cp.async of `W` bytes (W in {4, 8, 16}) from global to shared memory.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(W)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The first valid page at index >= j of row b (or npps if none): the
// sync kernels' skip rule, applied ahead of time.
__device__ __forceinline__ int next_valid(const int* __restrict__ row, int j,
                                          int npps, int page_size,
                                          int length, int n_valid) {
  for (; j < npps && j * page_size < length; ++j) {
    const int e = row[j];
    if (e >= 0 && e < n_valid) return j;
  }
  return npps;
}

// Issue the copy of one page's raw K/V tile of head h into a ring stage
// ([page, dh] rows, compact). `vec` is the copy width in bytes: 16, 8 or 4
// with cp.async, 0 for a plain element-wise load (rows whose byte length
// is not a multiple of 4).
template <typename T>
__device__ void issue_tile(const T* __restrict__ kp, const T* __restrict__ vp,
                           T* kst, T* vst, int h, int Hkv, int dh,
                           int page_size, int vec) {
  const int row_bytes = dh * (int)sizeof(T);
  if (vec == 0) {
    for (int i = threadIdx.x; i < page_size * dh; i += blockDim.x) {
      const int t = i / dh, d = i % dh;
      const long long off = ((long long)t * Hkv + h) * dh + d;
      kst[i] = kp[off];
      vst[i] = vp[off];
    }
    return;
  }
  const int per_row = row_bytes / vec;
  for (int c = threadIdx.x; c < page_size * per_row; c += blockDim.x) {
    const int t = c / per_row, w = c % per_row;
    const long long src = (((long long)t * Hkv + h) * dh) * sizeof(T) +
                          (long long)w * vec;
    const long long dst = (long long)t * row_bytes + (long long)w * vec;
    const char* ks = (const char*)kp + src;
    const char* vs = (const char*)vp + src;
    char* kd = (char*)kst + dst;
    char* vd = (char*)vst + dst;
    if (vec == 16) {
      cp_async<16>(kd, ks);
      cp_async<16>(vd, vs);
    } else if (vec == 8) {
      cp_async<8>(kd, ks);
      cp_async<8>(vd, vs);
    } else {
      cp_async<4>(kd, ks);
      cp_async<4>(vd, vs);
    }
  }
}

// Hot-slot attention with K/V page tiles double-buffered by cp.async:
// page j+1 (the next valid one) is issued before page j is waited on, so
// its load overlaps page j's update. Shared memory: the raw ring
// [2 stages][k, v][page, dh] of T, then the f32 working set.
template <typename T>
__global__ void paged_attention_async_kernel(
    const T* __restrict__ q, const T* __restrict__ k_hot,
    const T* __restrict__ v_hot, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out, int Hkv, int G,
    int dh, int page_size, int npps, int n_slots, float sm_scale, int vec,
    size_t ring_bytes) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int tile = page_size * dh;
  T* ring = (T*)smem;                          // stage s: k at 2s, v at 2s+1
  const Smem sm = carve((float*)((char*)smem + ring_bytes), G, dh,
                        page_size);
  const long long qbase = ((long long)b * Hkv + h) * G * dh;
  const int length = lengths[b];
  const int* row = table + (long long)b * npps;
  const long long page_elems = (long long)page_size * Hkv * dh;
  const long long base = (long long)b * n_slots;

  int j = next_valid(row, 0, npps, page_size, length, n_slots);
  if (j < npps) {                              // warm-up: issue the first page
    const long long pidx = base + row[j];
    issue_tile<T>(k_hot + pidx * page_elems, v_hot + pidx * page_elems, ring,
                  ring + tile, h, Hkv, dh, page_size, vec);
  }
  cp_async_commit();
  init_block(q, qbase, G, dh, sm_scale, sm);   // overlaps the first copy

  for (int stage = 0; j < npps; stage ^= 1) {
    const int nxt = next_valid(row, j + 1, npps, page_size, length, n_slots);
    if (nxt < npps) {                          // prefetch the next valid page
      const long long pidx = base + row[nxt];
      T* st = ring + 2 * (stage ^ 1) * tile;
      issue_tile<T>(k_hot + pidx * page_elems, v_hot + pidx * page_elems, st,
                    st + tile, h, Hkv, dh, page_size, vec);
    }
    cp_async_commit();                         // possibly an empty group
    cp_async_wait_prev();                      // page j has landed (own copies)
    __syncthreads();                           // ... and everyone else's
    const T* kst = ring + 2 * stage * tile;
    const T* vst = kst + tile;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      sm.k[i] = to_f32(kst[i]);
      sm.v[i] = to_f32(vst[i]);
    }
    __syncthreads();                           // stage free for the next issue
    attend_loaded(dh, page_size, G, j, length, sm);
    j = nxt;
  }
  store_out(out, qbase, G, dh, sm);
}

template <typename Kern>
void allow_smem(Kern kern, size_t smem) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
}

template <bool HOT>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lengths, void* out, int B, int Hkv, int G, int dh,
           int page_size, int npps, int n_valid, float sm_scale, int bf16,
           void* stream) {
  if (B <= 0 || Hkv <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * f32_floats(G, dh, page_size);
  const dim3 grid(B * Hkv);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    auto kern = paged_attention_kernel<__nv_bfloat16, HOT>;
    allow_smem(kern, smem);
    kern<<<grid, THREADS, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)table, (const int*)lengths,
        (__nv_bfloat16*)out, Hkv, G, dh, page_size, npps, n_valid, sm_scale);
  } else {
    auto kern = paged_attention_kernel<float, HOT>;
    allow_smem(kern, smem);
    kern<<<grid, THREADS, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const int*)table, (const int*)lengths, (float*)out, Hkv, G, dh,
        page_size, npps, n_valid, sm_scale);
  }
  return (int)cudaGetLastError();
}

// The widest copy (16, 8, 4 bytes) that divides a row and both bases;
// 0 when none does.
int copy_width(const void* k, const void* v, int row_bytes) {
  for (int w = 16; w >= 4; w /= 2) {
    if (row_bytes % w == 0 && (uintptr_t)k % w == 0 && (uintptr_t)v % w == 0)
      return w;
  }
  return 0;
}

template <typename T>
int launch_async(const void* q, const void* k, const void* v,
                 const void* table, const void* lengths, void* out, int S,
                 int Hkv, int G, int dh, int page_size, int npps,
                 int n_slots, float sm_scale, void* stream) {
  const int vec = copy_width(k, v, dh * (int)sizeof(T));
  // raw ring, rounded up to 16 bytes so the f32 part stays aligned
  const size_t ring = ((4 * (size_t)page_size * dh * sizeof(T)) + 15) / 16 * 16;
  const size_t smem = ring + sizeof(float) * f32_floats(G, dh, page_size);
  auto kern = paged_attention_async_kernel<T>;
  allow_smem(kern, smem);
  kern<<<dim3(S * Hkv), THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)table,
      (const int*)lengths, (T*)out, Hkv, G, dh, page_size, npps, n_slots,
      sm_scale, vec, ring);
  return (int)cudaGetLastError();
}

}  // namespace

// flat pool [n_pages, page, Hkv, dh]; table entries are page ids
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* out, int B, int Hkv, int G, int dh,
    int page_size, int npps, int n_pages, float sm_scale, int bf16,
    void* stream) {
  return launch<false>(q, k_pool, v_pool, table, lengths, out, B, Hkv, G, dh,
                       page_size, npps, n_pages, sm_scale, bf16, stream);
}

// per-stream hot pools [S, n_slots, page, Hkv, dh]; entries are slot ids
extern "C" int paged_attention_hot_slots_launch(
    const void* q, const void* k_hot, const void* v_hot, const void* table,
    const void* lengths, void* out, int S, int Hkv, int G, int dh,
    int page_size, int npps, int n_slots, float sm_scale, int bf16,
    void* stream) {
  return launch<true>(q, k_hot, v_hot, table, lengths, out, S, Hkv, G, dh,
                      page_size, npps, n_slots, sm_scale, bf16, stream);
}

// the same contract, K/V page tiles double-buffered with cp.async
extern "C" int paged_attention_hot_slots_async_launch(
    const void* q, const void* k_hot, const void* v_hot, const void* table,
    const void* lengths, void* out, int S, int Hkv, int G, int dh,
    int page_size, int npps, int n_slots, float sm_scale, int bf16,
    void* stream) {
  if (S <= 0 || Hkv <= 0) return (int)cudaSuccess;
  if (bf16)
    return launch_async<__nv_bfloat16>(q, k_hot, v_hot, table, lengths, out,
                                       S, Hkv, G, dh, page_size, npps,
                                       n_slots, sm_scale, stream);
  return launch_async<float>(q, k_hot, v_hot, table, lengths, out, S, Hkv, G,
                             dh, page_size, npps, n_slots, sm_scale, stream);
}
