// Paged decode attention for Hopper: one query token per sequence against
// KV pages named by a table, with an f32 online softmax over the pages in
// table order.
//
// Replaces the Pallas TPU kernels paged_attention_fwd (_paged_kernel) and
// paged_attention_hot_slots_fwd (_hot_slots_kernel) of
// src/repro/kernels/paged_attention/kernel.py, and their shared per-page
// update _attend_page.
//
// Both kernels are one template; they differ only in how they find a page:
//   flat (HOT=false): page = pool + pt * page_stride, valid iff 0 <= pt < n
//   hot  (HOT=true):  page = hot + (s * n_slots + slot) * page_stride,
//                     valid iff 0 <= slot < n_slots
// The per-page update attend_page() follows _attend_page op for op: scores
// in f32 against q * sm_scale, masked to -1e30, then m_new, m_safe, p, corr,
// l and acc in that order, K/V widened from their storage type to f32. The
// thread mapping and every reduction order are the same in both kernels,
// so on the same bytes in the same page order their outputs are bitwise
// equal -- the property the serving engine's fused-vs-flat pin relies on.
//
// A page that is fully masked (an invalid table entry, or a page wholly
// past the length) is skipped without reading it. That is bit-exact: the
// JAX update then gives corr = 1 (or 0 with acc = l = 0) and p = 0, which
// leaves (m, l, acc) unchanged. Both kernels skip the same way.
//
// Layout: q [B, Hkv, G, dh]; pages [.., page_size, Hkv, dh]; out like q.
// One block per (b, h); the G query heads of the group are held together.
//
// Bound: memory -- the K/V bytes of the valid tokens plus q and o. One
// block per (sequence, KV head) is 16 blocks on 132 SMs at the serving
// path's shapes, so the kernel is far from that bound; splitting the pages
// across blocks (flash-decoding) is later work and must split both kernels
// the same way.

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

// Shared-memory working set of one block.
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

// One page's online-softmax update for the G grouped heads (_attend_page).
// `kp` / `vp` point at the page's first element of K and V.
template <typename T>
__device__ void attend_page(const T* __restrict__ kp,
                            const T* __restrict__ vp, int h, int Hkv, int dh,
                            int page_size, int G, int j, int length,
                            Smem sm) {
  const int tid = threadIdx.x;
  // K/V tiles of KV head h, widened to f32
  for (int i = tid; i < page_size * dh; i += blockDim.x) {
    const int t = i / dh, d = i % dh;
    const long long off = ((long long)t * Hkv + h) * dh + d;
    sm.k[i] = to_f32(kp[off]);
    sm.v[i] = to_f32(vp[off]);
  }
  __syncthreads();
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
  Smem sm;
  sm.q = smem;
  sm.k = sm.q + G * dh;
  sm.v = sm.k + page_size * dh;
  sm.s = sm.v + page_size * dh;
  sm.acc = sm.s + G * page_size;
  sm.m = sm.acc + G * dh;
  sm.l = sm.m + G;
  sm.corr = sm.l + G;

  const long long qbase = ((long long)b * Hkv + h) * G * dh;
  for (int i = threadIdx.x; i < G * dh; i += blockDim.x) {
    sm.q[i] = to_f32(q[qbase + i]) * sm_scale;
    sm.acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    sm.m[g] = NEG_INF;
    sm.l[g] = 0.f;
  }
  __syncthreads();

  const int length = lengths[b];
  const long long page_elems = (long long)page_size * Hkv * dh;
  for (int j = 0; j < npps && j * page_size < length; ++j) {
    const int e = table[(long long)b * npps + j];
    if (e < 0 || e >= n_valid) continue;        // masked page: skipped
    // the only difference between the two kernels: where the page lives
    const long long pidx = HOT ? (long long)b * n_valid + e : (long long)e;
    attend_page<T>(k_pool + pidx * page_elems, v_pool + pidx * page_elems,
                   h, Hkv, dh, page_size, G, j, length, sm);
  }
  for (int i = threadIdx.x; i < G * dh; i += blockDim.x) {
    store(out + qbase + i, sm.acc[i] / fmaxf(sm.l[i / dh], 1e-30f));
  }
}

template <bool HOT>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lengths, void* out, int B, int Hkv, int G, int dh,
           int page_size, int npps, int n_valid, float sm_scale, int bf16,
           void* stream) {
  if (B <= 0 || Hkv <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) *
      ((size_t)2 * G * dh + 2 * (size_t)page_size * dh + (size_t)G * page_size
       + 3 * (size_t)G);
  const dim3 grid(B * Hkv);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    auto kern = paged_attention_kernel<__nv_bfloat16, HOT>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    kern<<<grid, THREADS, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)table, (const int*)lengths,
        (__nv_bfloat16*)out, Hkv, G, dh, page_size, npps, n_valid, sm_scale);
  } else {
    auto kern = paged_attention_kernel<float, HOT>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    kern<<<grid, THREADS, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const int*)table, (const int*)lengths, (float*)out, Hkv, G, dh,
        page_size, npps, n_valid, sm_scale);
  }
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
