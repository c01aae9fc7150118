// Paged decode attention for Hopper: one query token per sequence against
// KV pages named by a table, with an f32 online softmax, the pages split
// across blocks (flash-decoding) and the splits merged in a fixed order.
//
// Replaces the Pallas TPU kernels paged_attention_fwd (_paged_kernel),
// paged_attention_hot_slots_fwd (_hot_slots_kernel) and
// paged_attention_hot_slots_async_fwd (_hot_slots_async_kernel) of
// src/repro/kernels/paged_attention/kernel.py, and their shared per-page
// update _attend_page.
//
// Grid. The Pallas kernels walk the pages as the innermost, sequential grid
// dimension of one TPU core; here block (b * Hkv + h, s, z) takes query row
// (b, h), heads [8 z, 8 z + 8) of its group and split s: the pages
// [s * P, min((s + 1) * P, npps)) of the row's table, walked in table
// order. P (pages_per_split), n_split and the route below come from host
// rules of the call's shape (kernel.py: split_pages, tensor_core_route), so
// the three kernels of a pinned pair split and compute alike. A page whose
// entry is invalid, or which lies wholly past the length, is skipped
// without being read; that is bit-exact, since such a page leaves
// (m, l, acc) unchanged. A warp finds its next page from a ballot over 32
// table entries its lanes hold, so the walk waits on no load.
//
// Merge. Each warp keeps its own (m, l, acc); the block merges its warps in
// order 0..3 and writes the split's partial in f32 to a workspace the
// wrapper allocates, and a second kernel (combine) merges the n_split
// partials of each (b, h, g) in split order 0 .. n-1:
//   m* = max m_s;  corr_s = 0 if m_s <= -1e30 / 2, else exp(m_s - m*);
//   out = sum corr_s * acc_s / max(sum corr_s * l_s, 1e-30).
// A split with no valid token has m = -1e30, l = 0, acc = 0; a row with none
// gives 0. With one split the block writes out itself by the same formula
// (its single corr is 1), so no combine runs. No atomics.
//
// The per-page update, two routes:
//   tensor cores (bf16 at page size 16, head dim 64 or 128: the serving
//     paths): a warp takes whole pages, the k-th valid page of the split
//     going to warp k % 4. S = Q K^T and O += P V run on mma.sync m16n8k16
//     with f32 accumulation, the block's 8 heads as rows 0..7 of the m16
//     tile. Q and K fragments come from 16-byte loads (the head dim is
//     walked in a permuted order both operands share), S is scaled in f32,
//     P is split into three bf16 parts whose sum is p to 2^-24, and V's
//     fragments come from a per-warp shared-memory stage by ldmatrix.trans.
//   CUDA cores (f32, where TF32 would miss 2e-5, and every other shape): a
//     K/V row is read by a group of L lanes of 16 bytes each (8 bf16 or 4
//     f32 elements; L a power of two), a warp holds 32 / L token rows at
//     once; a row over 512 bytes takes the whole warp, each lane holding C
//     (2 or 4) chunks of 16 bytes 512 bytes apart, so rows of up to 2048
//     bytes (dh 1024 in bf16, 512 in f32) are taken; the dot products and
//     the max over the warp's tokens are butterflies of shuffles,
//     q * sm_scale and the accumulator live in registers, and two passes of
//     loads are in flight per thread.
// Both follow _attend_page op for op -- m_new, m_safe, corr, p, l, acc --
// without its selects (a masked score is -1e30, so exp(s - m_safe) is 0,
// and exp(m_old - m_safe) is 0 where m_old is -1e30), and rescale acc only
// when a max rose (corr is 1 otherwise).
//
// The three kernels differ only in how they find a page and how its bytes
// reach the lanes:
//   flat (HOT=false): page = pool + e * page_stride, valid iff 0 <= e < n
//   hot  (HOT=true):  page = hot + (b * n_slots + e) * page_stride,
//                     valid iff 0 <= e < n_slots
//   hot async:        the hot addressing; the next valid page of the split
//                     (tensor cores: of the warp) is copied with cp.async
//                     (16/8/4-byte copies, or an element loop for rows of
//                     odd byte length) into a 2-stage ring before the
//                     current one is waited on.
// All three run the same update, merge and combine in the same order on the
// same bytes, so their outputs are bitwise equal -- the property the
// serving engine's fused-vs-flat pin relies on.
//
// Layout: q [B, Hkv, G, dh]; pages [.., page_size, Hkv, dh]; out like q.
//
// Bound: memory -- the K/V bytes of the valid tokens plus q and o. The split
// gives the serving paths' batches about two blocks a SM; what keeps the
// kernels above the bound is latency: a block's chain of table, K/V, a few
// pages of updates and its merge, then the combine's second launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;          // warps a block
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DEPTH = 2;   // passes of K/V loads a thread keeps in flight
constexpr int CHUNK = 32;  // partials a combine thread loads up front

// elements of a row one lane holds: 16 bytes
template <typename T>
struct Ept {
  static constexpr int n = 16 / (int)sizeof(T);
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// What every kernel of this file is given (by value, in parameter space).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* table;
  const int* lengths;
  void* out;
  float* ws;      // [rows, n_split, G, dh] acc, then [rows, n_split, G] m, l
  int rows;       // B * Hkv
  int Hkv, G, dh, page_size, npps;
  int n_valid;    // pool pages (flat) or hot slots (hot): entries < this
  int pps;        // pages a split
  int n_split;
  int lg;         // log2 of the lanes a row
  int vec;        // CUDA-core sync kernels: 16-byte loads (1) or elements
                  // (0); the others: the copy width (16, 8, 4 or 0)
  float sm_scale;
};

// The 16 raw bytes one lane holds of a K or V row.
struct Raw {
  uint32_t w[4];
};

__device__ __forceinline__ void zero(Raw& r) {
  r.w[0] = r.w[1] = r.w[2] = r.w[3] = 0u;
}

// A lane's share of one token's K and V rows: C chunks of 16 bytes each.
template <int C>
struct KV {
  Raw k[C], v[C];
};

template <int C>
__device__ __forceinline__ void zero(KV<C>& r) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    zero(r.k[c]);
    zero(r.v[c]);
  }
}

// Read `n` (<= Ept) elements at `src` (device or shared memory) into `r`,
// the rest 0: one 16-byte load where `vec` allows it, else one per element.
template <typename T>
__device__ __forceinline__ void read_chunk(Raw& r, const T* src, int n,
                                           bool vec) {
  constexpr int E = Ept<T>::n;
  if (vec && n == E) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    r.w[0] = u.x;
    r.w[1] = u.y;
    r.w[2] = u.z;
    r.w[3] = u.w;
    return;
  }
  zero(r);
  if constexpr (sizeof(T) == 2) {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < n) r.w[e >> 1] |= (uint32_t)s[e] << (16 * (e & 1));
  } else {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < n) r.w[e] = s[e];
  }
}

// The raw bytes as f32 (bf16 -> f32 is exact).
template <typename T>
__device__ __forceinline__ void widen(const Raw& r, float (&f)[Ept<T>::n]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(r.w[i] << 16);
      f[2 * i + 1] = __uint_as_float(r.w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(r.w[i]);
  }
}

// Where one thread sits.
struct Geom {
  int row, b, h, s;  // query row (b, h) and split of the block
  int g0, gn;        // first head of the block and heads it holds
  int w, gi, tpw;    // warp, lane group in the warp, groups (token rows) a warp
  int d0, cw;        // first element of the lane's share; elements from one
                     // of its chunks to the next (rows over 512 bytes)
  int npass;         // passes a page
};

template <typename T>
__device__ __forceinline__ Geom make_geom(const Args& a, int gm) {
  Geom g;
  g.row = blockIdx.x;
  g.b = g.row / a.Hkv;
  g.h = g.row % a.Hkv;
  g.s = blockIdx.y;
  g.g0 = blockIdx.z * gm;
  g.gn = min(gm, a.G - g.g0);
  const int lane = threadIdx.x & 31;
  g.w = threadIdx.x >> 5;
  g.gi = lane >> a.lg;
  g.tpw = 32 >> a.lg;
  g.d0 = (lane & ((1 << a.lg) - 1)) * Ept<T>::n;
  g.cw = Ept<T>::n << a.lg;
  g.npass = (a.page_size + NW * g.tpw - 1) / (NW * g.tpw);
  return g;
}

// Elements of the lane's chunk c (0 past the row's end).
template <typename T>
__device__ __forceinline__ int chunk_n(const Args& a, const Geom& g, int c) {
  return max(0, min(Ept<T>::n, a.dh - g.d0 - c * g.cw));
}

// One thread's running state for GM heads, C chunks of a row each.
template <typename T, int GM, int C>
struct State {
  float q[GM][C * Ept<T>::n];    // q * sm_scale, the lane's elements (0 past
                                 // G)
  float m[GM];                   // running max, the same in every lane of a
                                 // warp
  float l[GM];                   // running sum of p over the group's tokens
  float acc[GM][C * Ept<T>::n];  // running sum of p * v over the group's
                                 // tokens
};

template <typename T, int GM, int C>
__device__ __forceinline__ void init_state(const Args& a, const Geom& g,
                                           State<T, GM, C>& st) {
  constexpr int E = Ept<T>::n;
  const T* q = (const T*)a.q + ((long long)g.row * a.G + g.g0) * a.dh + g.d0;
  const bool vec = (a.dh * (int)sizeof(T)) % 16 == 0 &&
                   ((uintptr_t)a.q & 15) == 0;
#pragma unroll
  for (int h = 0; h < GM; ++h) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int n = chunk_n<T>(a, g, c);
      Raw r;
      if (h < g.gn && n > 0)
        read_chunk<T>(r, q + h * a.dh + c * g.cw, n, vec);
      else
        zero(r);
      float f[E];
      widen<T>(r, f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        st.q[h][c * E + e] = f[e] * a.sm_scale;
        st.acc[h][c * E + e] = 0.f;
      }
    }
    st.m[h] = NEG_INF;
    st.l[h] = 0.f;
  }
}

// The valid pages of one split, in table order (the skip rule: an invalid
// entry, or a page wholly past the length, is not read). A warp holds 32
// entries of the split at a time, one a lane, and a ballot of the valid
// ones, so finding the next page waits on no load. Every lane of the warp
// calls seek() alike.
struct Pages {
  const int* row;
  int j, j1, page_size, length, n_valid;
  int e;        // the table entry of page j
  int c0;       // first page of the 32 the lanes hold
  int mine;     // this lane's entry, page c0 + lane
  unsigned ok;  // which of the 32 are valid
  __device__ __forceinline__ void hold(int from) {
    c0 = from;
    const int p = c0 + (threadIdx.x & 31);
    mine = p < j1 ? row[p] : -1;
    ok = __ballot_sync(FULL, p < j1 && p * page_size < length && mine >= 0 &&
                                 mine < n_valid);
  }
  __device__ __forceinline__ void seek(int from) {
    while (from < j1) {
      if (from >= c0 + 32) hold(from);
      const unsigned m = ok & (FULL << (from - c0));
      if (m) {
        const int k = __ffs(m) - 1;
        j = c0 + k;
        e = __shfl_sync(FULL, mine, k);
        return;
      }
      from = c0 + 32;
    }
    j = j1;
  }
  __device__ __forceinline__ bool done() const { return j >= j1; }
  // the n-th valid page after page j
  __device__ __forceinline__ void next(int n) {
    for (int k = 0; k < n && !done(); ++k) seek(j + 1);
  }
};

__device__ __forceinline__ Pages split_range(const Args& a, const Geom& g) {
  Pages pg;
  pg.row = a.table + (long long)g.b * a.npps;
  pg.j1 = min((g.s + 1) * a.pps, a.npps);
  pg.page_size = a.page_size;
  pg.length = a.lengths[g.b];
  pg.n_valid = a.n_valid;
  pg.e = -1;
  pg.hold(g.s * a.pps);
  pg.seek(g.s * a.pps);
  return pg;
}

// The token the thread's group holds in pass i of page pg.j, and whether it
// is inside the page and the length.
__device__ __forceinline__ bool token(const Args& a, const Geom& g,
                                      const Pages& pg, int i, int& t) {
  t = (i * NW + g.w) * g.tpw + g.gi;
  return t < a.page_size && pg.j * a.page_size + t < pg.length;
}

// Element offset of (page pidx, token t, head h, the lane's first element).
__device__ __forceinline__ long long row_offset(const Args& a, const Geom& g,
                                                long long pidx, int t) {
  return ((pidx * a.page_size + t) * a.Hkv + g.h) * a.dh + g.d0;
}

// One pass of _attend_page over the tokens a warp holds (one a lane group;
// `valid` masks the group's token). Every lane of the warp calls it.
template <typename T, int GM, int C>
__device__ __forceinline__ void attend_pass(State<T, GM, C>& st,
                                            const KV<C>& kv, bool valid,
                                            int lg) {
  constexpr int E = Ept<T>::n;
  float s[GM];
#pragma unroll
  for (int h = 0; h < GM; ++h) s[h] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float k[E];
    widen<T>(kv.k[c], k);
#pragma unroll
    for (int h = 0; h < GM; ++h) {
#pragma unroll
      for (int e = 0; e < E; ++e) s[h] = fmaf(st.q[h][c * E + e], k[e], s[h]);
    }
  }
  // the dot products: a butterfly over the group's lanes (a + b == b + a,
  // so every lane of the group ends with the same sum)
  for (int off = (1 << lg) >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int h = 0; h < GM; ++h) s[h] += __shfl_xor_sync(FULL, s[h], off);
  }
  float mx[GM];
#pragma unroll
  for (int h = 0; h < GM; ++h) {
    s[h] = valid ? s[h] : NEG_INF;
    mx[h] = s[h];
  }
  // the max over the warp's tokens
  for (int off = 16; off >= (1 << lg); off >>= 1) {
#pragma unroll
    for (int h = 0; h < GM; ++h)
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], off));
  }
  // _attend_page's m_new, m_safe, corr, p, l, acc. Its two where()s need
  // no select here: a masked score is -1e30, so exp(s - m_safe) is 0, and
  // exp(m_old - m_safe) is 0 where m_old is -1e30. corr is 1 where no max
  // rose, so the rescale runs only when one did (the whole warp alike).
  float m_new[GM], m_safe[GM], corr[GM];
  bool rose = false;
#pragma unroll
  for (int h = 0; h < GM; ++h) {
    m_new[h] = fmaxf(st.m[h], mx[h]);
    m_safe[h] = m_new[h] <= NEG_INF / 2 ? 0.f : m_new[h];
    rose |= m_new[h] != st.m[h];
    corr[h] = 1.f;
  }
  if (rose) {
#pragma unroll
    for (int h = 0; h < GM; ++h) {
      corr[h] = expf(st.m[h] - m_safe[h]);
#pragma unroll
      for (int e = 0; e < C * E; ++e) st.acc[h][e] *= corr[h];
    }
  }
  float p[GM];
#pragma unroll
  for (int h = 0; h < GM; ++h) {
    p[h] = expf(s[h] - m_safe[h]);
    st.l[h] = fmaf(st.l[h], corr[h], p[h]);
    st.m[h] = m_new[h];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float v[E];
    widen<T>(kv.v[c], v);
#pragma unroll
    for (int h = 0; h < GM; ++h) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        st.acc[h][c * E + e] = fmaf(p[h], v[e], st.acc[h][c * E + e]);
    }
  }
}

// The weight of a partial with max m_s under the common max mx.
__device__ __forceinline__ float merge_corr(float m_s, float mx) {
  return m_s <= NEG_INF / 2 ? 0.f : expf(m_s - mx);
}

// The block's merge: each warp has put its partial (acc [GM][dh], m, l of
// its GM heads) in shared memory; merge the warps in order 0..NW-1 and write
// the split's partial to the workspace (or, with one split, the output).
// `smem` holds GM * (NW * (dh + 2) + 1) floats: acc, then m, then l, then
// the block's max.
template <typename T, int GM>
__device__ __forceinline__ void merge_block(const Args& a, int row, int s,
                                            int g0, int gn, float* smem) {
  float* sa = smem;                      // [NW][GM][dh]
  float* sm = sa + NW * GM * a.dh;       // [NW][GM] m, then corr
  float* sl = sm + NW * GM;              // [NW][GM] l
  float* sx = sl + NW * GM;              // [GM] the block's max
  __syncthreads();
  float corr = 0.f;                      // thread w * GM + h: warp w, head h
  if (threadIdx.x < NW * GM) {
    const int h = threadIdx.x % GM;
    float mx = NEG_INF;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm[w * GM + h]);
    corr = merge_corr(sm[threadIdx.x], mx);
    if (threadIdx.x < GM) sx[h] = mx;
  }
  __syncthreads();
  if (threadIdx.x < NW * GM) sm[threadIdx.x] = corr;
  __syncthreads();
  const long long cells = (long long)a.rows * a.n_split * a.G;
  float* ws_m = a.ws + cells * a.dh;
  float* ws_l = ws_m + cells;
  for (int h = 0; h < gn; ++h) {
    for (int d = threadIdx.x; d < a.dh; d += THREADS) {
      float ls = 0.f, as = 0.f;
      for (int w = 0; w < NW; ++w) {
        ls = fmaf(sm[w * GM + h], sl[w * GM + h], ls);
        as = fmaf(sm[w * GM + h], sa[(w * GM + h) * a.dh + d], as);
      }
      if (a.n_split == 1) {
        const long long o = ((long long)row * a.G + g0 + h) * a.dh + d;
        store((T*)a.out + o, as / fmaxf(ls, 1e-30f));
      } else {
        const long long c = ((long long)row * a.n_split + s) * a.G + g0 + h;
        a.ws[c * a.dh + d] = as;
        if (d == 0) {
          ws_m[c] = sx[h];
          ws_l[c] = ls;
        }
      }
    }
  }
}

// End of a split on the CUDA-core route: sum the groups of each warp, put
// the warps' partials in shared memory (free by now) and merge the block.
template <typename T, int GM, int C>
__device__ __forceinline__ void finish(const Args& a, const Geom& g,
                                       State<T, GM, C>& st, float* smem) {
  constexpr int E = Ept<T>::n;
  for (int off = 32 / g.tpw; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < GM; ++h) {
      st.l[h] += __shfl_xor_sync(FULL, st.l[h], off);
#pragma unroll
      for (int e = 0; e < C * E; ++e)
        st.acc[h][e] += __shfl_xor_sync(FULL, st.acc[h][e], off);
    }
  }
  float* sa = smem;
  float* sm = sa + NW * GM * a.dh;
  float* sl = sm + NW * GM;
  if (g.gi == 0) {
#pragma unroll
    for (int h = 0; h < GM; ++h) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int n = chunk_n<T>(a, g, c);
        float* dst = sa + (g.w * GM + h) * a.dh + g.d0 + c * g.cw;
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (e < n) dst[e] = st.acc[h][c * E + e];
      }
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int h = 0; h < GM; ++h) {
      sm[g.w * GM + h] = st.m[h];
      sl[g.w * GM + h] = st.l[h];
    }
  }
  merge_block<T, GM>(a, g.row, g.s, g.g0, g.gn, smem);
}

// The sync kernels: flat pool (HOT=false) or per-stream hot pools (HOT=true).
// DEPTH passes of loads are in flight in registers: a pass's slot is
// refilled with the pass DEPTH ahead before the pass is attended.
template <typename T, bool HOT, int C>
__device__ __forceinline__ void fetch(const Args& a, const Geom& g,
                                      const Pages& pg, int i, KV<C>& kv,
                                      bool& valid) {
  int t;
  valid = token(a, g, pg, i, t);
  zero(kv);
  if (!valid) return;
  const long long pidx =
      HOT ? (long long)g.b * a.n_valid + pg.e : (long long)pg.e;
  const long long off = row_offset(a, g, pidx, t);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int n = chunk_n<T>(a, g, c);
    if (n == 0) continue;
    read_chunk<T>(kv.k[c], (const T*)a.k + off + c * g.cw, n, a.vec);
    read_chunk<T>(kv.v[c], (const T*)a.v + off + c * g.cw, n, a.vec);
  }
}

__device__ __forceinline__ void advance(Pages& pg, int& i, int npass) {
  if (++i == npass) {
    i = 0;
    pg.seek(pg.j + 1);
  }
}

template <typename T, int GM, int C, bool HOT>
__global__ void __launch_bounds__(THREADS)
    paged_attention_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Geom g = make_geom<T>(a, GM);
  Pages pg = split_range(a, g);
  State<T, GM, C> st;
  init_state(a, g, st);
  int i = 0;
  KV<C> kv[DEPTH];
  bool ok[DEPTH], has[DEPTH];
#pragma unroll
  for (int u = 0; u < DEPTH; ++u) {
    has[u] = !pg.done();
    if (has[u]) {
      fetch<T, HOT>(a, g, pg, i, kv[u], ok[u]);
      advance(pg, i, g.npass);
    }
  }
  for (bool more = has[0]; more;) {
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      if (!has[u]) {                    // the passes ran out (all slots after
        more = false;                   // this one are empty too)
        break;
      }
      const KV<C> cur = kv[u];
      const bool o = ok[u];
      has[u] = !pg.done();
      if (has[u]) {
        fetch<T, HOT>(a, g, pg, i, kv[u], ok[u]);
        advance(pg, i, g.npass);
      }
      attend_pass(st, cur, o, a.lg);
    }
  }
  finish(a, g, st, smem);
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int W>
__device__ __forceinline__ void copy_bytes(char* kd, char* vd, const char* ks,
                                           const char* vs, int bytes) {
  for (int o = 0; o < bytes; o += W) {
    cp_async<W>(kd + o, ks + o);
    cp_async<W>(vd + o, vs + o);
  }
}

// Issue the copies of this thread's shares of page pg.j into a ring stage
// ([k, v][page, dh] of T, compact): copies of a.vec bytes (16, 8 or 4), or
// an element loop (0) for rows whose byte length is not a multiple of 4.
template <typename T, int C>
__device__ __forceinline__ void issue_page(const Args& a, const Geom& g,
                                           const Pages& pg, T* kst) {
  T* vst = kst + a.page_size * a.dh;
  const long long pidx = (long long)g.b * a.n_valid + pg.e;
  for (int i = 0; i < g.npass; ++i) {
    int t;
    if (!token(a, g, pg, i, t)) continue;
    const long long off = row_offset(a, g, pidx, t);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int n = chunk_n<T>(a, g, c);
      if (n == 0) continue;
      const T* ks = (const T*)a.k + off + c * g.cw;
      const T* vs = (const T*)a.v + off + c * g.cw;
      T* kd = kst + t * a.dh + g.d0 + c * g.cw;
      T* vd = vst + t * a.dh + g.d0 + c * g.cw;
      const int bytes = n * (int)sizeof(T);
      if (a.vec == 16) {
        copy_bytes<16>((char*)kd, (char*)vd, (const char*)ks,
                       (const char*)vs, bytes);
      } else if (a.vec == 8) {
        copy_bytes<8>((char*)kd, (char*)vd, (const char*)ks,
                      (const char*)vs, bytes);
      } else if (a.vec == 4) {
        copy_bytes<4>((char*)kd, (char*)vd, (const char*)ks,
                      (const char*)vs, bytes);
      } else {
        for (int e = 0; e < n; ++e) {
          kd[e] = ks[e];
          vd[e] = vs[e];
        }
      }
    }
  }
}

// Hot-slot attention with a 2-stage cp.async ring per block: the next valid
// page of the split is issued before the current one is waited on. Each
// thread copies exactly the bytes it reads back, so the ring needs no block
// barrier. Shared memory: the ring, reused for the final merge.
template <typename T, int GM, int C>
__global__ void __launch_bounds__(THREADS)
    paged_attention_async_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  T* ring = (T*)smem;                  // stage s: k at 2s, v at 2s + 1
  const int tile = a.page_size * a.dh;
  const bool rvec = (a.dh * (int)sizeof(T)) % 16 == 0;
  const Geom g = make_geom<T>(a, GM);
  Pages pg = split_range(a, g);
  if (!pg.done()) issue_page<T, C>(a, g, pg, ring);  // warm-up: first page
  cp_async_commit();
  State<T, GM, C> st;
  init_state(a, g, st);                            // overlaps the first copy
  for (int stage = 0; !pg.done(); stage ^= 1) {
    Pages nxt = pg;
    nxt.seek(pg.j + 1);
    if (!nxt.done())
      issue_page<T, C>(a, g, nxt, ring + 2 * (stage ^ 1) * tile);
    cp_async_commit();                 // possibly an empty group
    cp_async_wait_prev();              // this thread's copies of page j landed
    const T* kst = ring + 2 * stage * tile;
    const T* vst = kst + tile;
    for (int i = 0; i < g.npass; ++i) {
      int t;
      const bool ok = token(a, g, pg, i, t);
      KV<C> kv;
      zero(kv);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int n = chunk_n<T>(a, g, c);
        if (!ok || n == 0) continue;
        const int o = t * a.dh + g.d0 + c * g.cw;
        read_chunk<T>(kv.k[c], kst + o, n, rvec);
        read_chunk<T>(kv.v[c], vst + o, n, rvec);
      }
      attend_pass(st, kv, ok, a.lg);
    }
    pg = nxt;
  }
  cp_async_wait_all();
  __syncthreads();                     // the ring is free for the merge
  finish(a, g, st, smem);
}

// ---- the bf16 tensor-core route ---------------------------------------------
//
// bf16 at page size 16 and head dim 64 or 128 (the serving paths' shapes):
// a warp takes whole pages, the k-th valid page of the split going to warp
// k % NW, and runs _attend_page on mma.sync m16n8k16 (f32 accumulation).
// S = Q K^T has the block's 8 heads as rows 0..7 of the m16 tile (rows
// 8..15 zero) and a page's 16 tokens as two n8 tiles. The head dim is
// walked in a permuted order that both operands share (a dot product does
// not depend on it): lane c of a quad holds elements [32 k + 8 c, +8) of its
// row for k-steps 2k and 2k+1, so Q and K fragments come from 16-byte loads.
// S is scaled by sm_scale in f32 after the product. The softmax then runs on
// the C fragments (a lane: head lane/4, tokens 2c, 2c+1 of each n8 tile;
// the page max over the quad by two shuffles), and P, split into three bf16
// parts whose sum is p to 2^-24, is the A operand of O += P V, V's B
// fragments read from a per-warp shared-memory stage with ldmatrix.trans.

constexpr int MPAGE = 16;   // the page size the route takes
constexpr int MHEADS = 8;   // heads a warp holds: rows 0..7 of each m16 tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi, float& rlo,
                                           float& rhi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  rlo = lo - __low2float(v);           // exact
  rhi = hi - __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The per-warp state of the route.
template <int D>
struct MState {
  uint32_t q[D / 32][4];   // Q fragment words of head lane/4 (0 past G)
  float m, l;              // head lane/4: running max (the quad's), the
                           // lane's running sum of p
  float o[D / 8][4];       // O's C fragments (rows 8..15 stay 0)
};

// K's B fragments of one page: token 8 nt + lane/4, elements [32 k + 8 c, +8)
template <int D>
using KFrag = uint32_t[2][D / 32][4];

// One page of _attend_page up to P: S, the mask, m_new, m_safe, corr (and
// the rescale of O where a max rose), p and l. Leaves P's three parts.
template <int D>
__device__ __forceinline__ void mma_scores(MState<D>& st, const KFrag<D>& kf,
                                           int j, int length, float sm_scale,
                                           uint32_t (&pa)[3][2]) {
  const int c = threadIdx.x & 3;
  float sc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
#pragma unroll
    for (int k = 0; k < D / 32; ++k) {
      mma_bf16(sc[nt], st.q[k][0], st.q[k][1], kf[nt][k][0], kf[nt][k][1]);
      mma_bf16(sc[nt], st.q[k][2], st.q[k][3], kf[nt][k][2], kf[nt][k][3]);
    }
  }
  float sv[4], mx = NEG_INF;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 8 * nt + 2 * c + e;
      const float x = sc[nt][e] * sm_scale;
      sv[2 * nt + e] = j * MPAGE + t < length ? x : NEG_INF;
      mx = fmaxf(mx, sv[2 * nt + e]);
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
  const float m_new = fmaxf(st.m, mx);
  const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
  float corr = 1.f;                    // as attend_pass: exact without selects
  if (__any_sync(FULL, m_new != st.m)) {
    corr = expf(st.m - m_safe);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      st.o[nd][0] *= corr;
      st.o[nd][1] *= corr;
    }
  }
  float p[4], ps = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = expf(sv[i] - m_safe);
    ps += p[i];
  }
  st.l = fmaf(st.l, corr, ps);
  st.m = m_new;
  // P's A fragment: tokens 2c, 2c+1 (tile 0) and 2c+8, 2c+9 (tile 1)
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    float r0, r1, s0, s1, u0, u1;
    pa[0][nt] = bf16x2(p[2 * nt], p[2 * nt + 1], r0, r1);
    pa[1][nt] = bf16x2(r0, r1, s0, s1);
    pa[2][nt] = bf16x2(s0, s1, u0, u1);
  }
}

// O += P V, V's page staged at `vs` as 16 rows of `row` bf16 elements.
template <int D>
__device__ __forceinline__ void mma_pv(MState<D>& st,
                                       const uint32_t (&pa)[3][2],
                                       const __nv_bfloat16* vs, int row) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const __nv_bfloat16* base = vs + ((mi & 1) * 8 + (lane & 7)) * row +
                              8 * (mi >> 1);
#pragma unroll
  for (int nd = 0; nd < D / 8; nd += 2) {
    uint32_t vb[4];
    ldmatrix_x4_trans(vb, base + 8 * nd);
#pragma unroll
    for (int part = 2; part >= 0; --part) {  // the small parts first
      mma_bf16(st.o[nd], pa[part][0], pa[part][1], vb[0], vb[1]);
      mma_bf16(st.o[nd + 1], pa[part][0], pa[part][1], vb[2], vb[3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void mma_init(const Args& a, const Geom& g,
                                         MState<D>& st) {
  const int lane = threadIdx.x & 31, hq = lane >> 2;
  const bool vec = ((uintptr_t)a.q & 15) == 0;
  const __nv_bfloat16* q = (const __nv_bfloat16*)a.q +
                           ((long long)g.row * a.G + g.g0 + hq) * D +
                           8 * (lane & 3);
#pragma unroll
  for (int k = 0; k < D / 32; ++k) {
    Raw r;
    if (hq < g.gn)
      read_chunk<__nv_bfloat16>(r, q + 32 * k, 8, vec);
    else
      zero(r);
#pragma unroll
    for (int i = 0; i < 4; ++i) st.q[k][i] = r.w[i];
  }
  st.m = NEG_INF;
  st.l = 0.f;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.o[nd][i] = 0.f;
}

// K's fragments from rows of `rs` elements (device memory or a stage).
template <int D>
__device__ __forceinline__ void mma_kfrag(KFrag<D>& kf,
                                          const __nv_bfloat16* k0, long long rs,
                                          bool vec) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const __nv_bfloat16* kr = k0 + (8 * nt + (lane >> 2)) * rs + 8 * (lane & 3);
#pragma unroll
    for (int k = 0; k < D / 32; ++k) {
      Raw r;
      read_chunk<__nv_bfloat16>(r, kr + 32 * k, 8, vec);
#pragma unroll
      for (int i = 0; i < 4; ++i) kf[nt][k][i] = r.w[i];
    }
  }
}

// Copy a page's 16 rows of `D` elements (row stride `rs` in device memory)
// into a stage of rows of D + 8, with copies of a.vec bytes, or (0: a base
// only 2-byte aligned) with plain loads and stores of single elements.
template <int D>
__device__ __forceinline__ void mma_stage(const Args& a,
                                          const __nv_bfloat16* src,
                                          long long rs, __nv_bfloat16* dst) {
  const int lane = threadIdx.x & 31;
  for (int ch = lane; ch < MPAGE * D / 8; ch += 32) {
    const int t = ch / (D / 8), x = 8 * (ch % (D / 8));
    const char* s = (const char*)(src + t * rs + x);
    char* d = (char*)(dst + t * (D + 8) + x);
    if (a.vec == 16) {
      cp_async<16>(d, s);
    } else if (a.vec == 8) {
      cp_async<8>(d, s);
      cp_async<8>(d + 8, s + 8);
    } else if (a.vec == 4) {
#pragma unroll
      for (int o = 0; o < 16; o += 4) cp_async<4>(d + o, s + o);
    } else {
      const unsigned short* se = (const unsigned short*)s;
      unsigned short* de = (unsigned short*)d;
#pragma unroll
      for (int e = 0; e < 8; ++e) de[e] = se[e];
    }
  }
}

// The warp's partial into shared memory (the stages are free by now), then
// the block's merge.
template <int D>
__device__ __forceinline__ void mma_finish(const Args& a, const Geom& g,
                                           MState<D>& st, float* smem) {
  const int lane = threadIdx.x & 31, hq = lane >> 2, c = lane & 3;
  st.l += __shfl_xor_sync(FULL, st.l, 1);
  st.l += __shfl_xor_sync(FULL, st.l, 2);
  __syncthreads();
  float* sa = smem;
  float* sm = sa + NW * MHEADS * D;
  float* sl = sm + NW * MHEADS;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    sa[(g.w * MHEADS + hq) * D + 8 * nd + 2 * c] = st.o[nd][0];
    sa[(g.w * MHEADS + hq) * D + 8 * nd + 2 * c + 1] = st.o[nd][1];
  }
  if (c == 0) {
    sm[g.w * MHEADS + hq] = st.m;
    sl[g.w * MHEADS + hq] = st.l;
  }
  merge_block<__nv_bfloat16, MHEADS>(a, g.row, g.s, g.g0, g.gn, smem);
}

// The sync kernels on the route: K's fragments straight from device memory,
// V through the warp's stage.
template <int D, bool HOT>
__global__ void __launch_bounds__(THREADS)
    paged_attention_mma_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Geom g = make_geom<__nv_bfloat16>(a, MHEADS);
  Pages pg = split_range(a, g);
  pg.next(g.w);                        // this warp's first page
  MState<D> st;
  mma_init(a, g, st);
  __nv_bfloat16* vs = (__nv_bfloat16*)smem + g.w * MPAGE * (D + 8);
  const long long rs = (long long)a.Hkv * D;   // token to token
  for (; !pg.done(); pg.next(NW)) {
    const long long pidx =
        HOT ? (long long)g.b * a.n_valid + pg.e : (long long)pg.e;
    const long long off = pidx * MPAGE * rs + (long long)g.h * D;
    mma_stage<D>(a, (const __nv_bfloat16*)a.v + off, rs, vs);
    cp_async_commit();
    KFrag<D> kf;
    mma_kfrag<D>(kf, (const __nv_bfloat16*)a.k + off, rs, a.vec == 16);
    uint32_t pa[3][2];
    mma_scores(st, kf, pg.j, pg.length, a.sm_scale, pa);
    cp_async_wait_all();
    __syncwarp();                      // every lane's copies of V landed
    mma_pv(st, pa, vs, D + 8);
    __syncwarp();                      // the stage is free again
  }
  mma_finish(a, g, st, smem);
}

// The async kernel on the route: each warp's 2-stage ring of K and V; the
// warp's next page is issued before it waits on the current one.
template <int D>
__global__ void __launch_bounds__(THREADS)
    paged_attention_mma_async_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TILE = MPAGE * (D + 8);
  const Geom g = make_geom<__nv_bfloat16>(a, MHEADS);
  Pages pg = split_range(a, g);
  pg.next(g.w);
  __nv_bfloat16* ring = (__nv_bfloat16*)smem + g.w * 4 * TILE;  // [2][k, v]
  const long long rs = (long long)a.Hkv * D;
  const long long base = (long long)g.b * a.n_valid;
  if (!pg.done()) {
    const long long off = (base + pg.e) * MPAGE * rs + (long long)g.h * D;
    mma_stage<D>(a, (const __nv_bfloat16*)a.k + off, rs, ring);
    mma_stage<D>(a, (const __nv_bfloat16*)a.v + off, rs, ring + TILE);
  }
  cp_async_commit();
  MState<D> st;
  mma_init(a, g, st);                  // overlaps the first copy
  for (int stage = 0; !pg.done(); stage ^= 1) {
    Pages nxt = pg;
    nxt.next(NW);
    if (!nxt.done()) {
      const long long off = (base + nxt.e) * MPAGE * rs + (long long)g.h * D;
      __nv_bfloat16* st2 = ring + 2 * (stage ^ 1) * TILE;
      mma_stage<D>(a, (const __nv_bfloat16*)a.k + off, rs, st2);
      mma_stage<D>(a, (const __nv_bfloat16*)a.v + off, rs, st2 + TILE);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncwarp();                      // page j landed, every lane's copies
    const __nv_bfloat16* ks = ring + 2 * stage * TILE;
    KFrag<D> kf;
    mma_kfrag<D>(kf, ks, D + 8, true);
    uint32_t pa[3][2];
    mma_scores(st, kf, pg.j, pg.length, a.sm_scale, pa);
    mma_pv(st, pa, ks + TILE, D + 8);
    __syncwarp();                      // the stage is free for the issue
    pg = nxt;
  }
  cp_async_wait_all();
  mma_finish(a, g, st, smem);
}

// ---- the combine -----------------------------------------------------------

// Block (row, g, z), a thread a column d in [COMBINE_THREADS z, +that):
// merge the n_split partials in split order into out. A thread loads its
// first CHUNK partials before the weights are known.
constexpr int COMBINE_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
    combine_kernel(const Args a) {
  extern __shared__ float cs[];        // [n_split] each: m, l, corr
  const int row = blockIdx.x, h = blockIdx.y, n = a.n_split;
  const int d = blockIdx.z * COMBINE_THREADS + threadIdx.x;
  const long long cells = (long long)a.rows * n * a.G;
  const float* ws_m = a.ws + cells * a.dh;
  const float* ws_l = ws_m + cells;
  const long long c0 = (long long)row * n * a.G + h;  // split 0
  const float* acc = a.ws + c0 * a.dh + d;
  const long long step = (long long)a.G * a.dh;        // split to split
  float pre[CHUNK];
#pragma unroll
  for (int s = 0; s < CHUNK; ++s)
    pre[s] = d < a.dh && s < n ? acc[s * step] : 0.f;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    cs[s] = ws_m[c0 + (long long)s * a.G];
    cs[n + s] = ws_l[c0 + (long long)s * a.G];
  }
  __syncthreads();
  float mx = NEG_INF;
#pragma unroll 8
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, cs[s]);
  float* corr = cs + 2 * n;
  for (int s = threadIdx.x; s < n; s += blockDim.x)
    corr[s] = merge_corr(cs[s], mx);
  __syncthreads();
  if (d >= a.dh) return;
  float ls = 0.f, as = 0.f;
#pragma unroll 8
  for (int s = 0; s < n; ++s) ls = fmaf(corr[s], cs[n + s], ls);
#pragma unroll
  for (int s = 0; s < CHUNK; ++s)
    if (s < n) as = fmaf(corr[s], pre[s], as);
#pragma unroll 8
  for (int s = CHUNK; s < n; ++s) as = fmaf(corr[s], acc[s * step], as);
  store((T*)a.out + ((long long)row * a.G + h) * a.dh + d,
        as / fmaxf(ls, 1e-30f));
}

// ---- launch ----------------------------------------------------------------

enum Kind { FLAT, HOT, HOT_ASYNC };

template <typename Kern>
void allow_smem(Kern kern, size_t smem) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
}

template <typename Kern>
void run_split(Kern kern, dim3 grid, size_t smem, const Args& a,
               cudaStream_t st) {
  allow_smem(kern, smem);
  kern<<<grid, THREADS, smem, st>>>(a);
}

// The combine, where there is more than one split.
template <typename T>
int combine(const Args& a, cudaStream_t st) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return (int)err;
  const int threads = a.dh < COMBINE_THREADS ? (a.dh + 31) / 32 * 32
                                             : COMBINE_THREADS;
  const int nz = (a.dh + COMBINE_THREADS - 1) / COMBINE_THREADS;
  combine_kernel<T><<<dim3(a.rows, a.G, nz), threads,
                      3 * sizeof(float) * a.n_split, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int GM, int C>
int launch(Kind kind, const Args& a, cudaStream_t st) {
  const dim3 grid(a.rows, a.n_split, (a.G + GM - 1) / GM);
  const size_t merge_bytes = sizeof(float) * GM * (NW * (a.dh + 2) + 1);
  if (kind == HOT_ASYNC) {
    const size_t ring = 4 * (size_t)a.page_size * a.dh * sizeof(T);
    run_split(paged_attention_async_kernel<T, GM, C>, grid,
              ring > merge_bytes ? ring : merge_bytes, a, st);
  } else if (kind == HOT) {
    run_split(paged_attention_kernel<T, GM, C, true>, grid, merge_bytes, a,
              st);
  } else {
    run_split(paged_attention_kernel<T, GM, C, false>, grid, merge_bytes, a,
              st);
  }
  return combine<T>(a, st);
}

template <int D>
int launch_mma(Kind kind, const Args& a, cudaStream_t st) {
  const dim3 grid(a.rows, a.n_split, (a.G + MHEADS - 1) / MHEADS);
  const size_t merge_bytes = sizeof(float) * MHEADS * (NW * (D + 2) + 1);
  const size_t tile = sizeof(__nv_bfloat16) * MPAGE * (D + 8);
  const size_t stages = NW * (kind == HOT_ASYNC ? 4 : 1) * tile;
  const size_t smem = stages > merge_bytes ? stages : merge_bytes;
  if (kind == HOT_ASYNC)
    run_split(paged_attention_mma_async_kernel<D>, grid, smem, a, st);
  else if (kind == HOT)
    run_split(paged_attention_mma_kernel<D, true>, grid, smem, a, st);
  else
    run_split(paged_attention_mma_kernel<D, false>, grid, smem, a, st);
  return combine<__nv_bfloat16>(a, st);
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

int run(Kind kind, const void* q, const void* k, const void* v,
        const void* table, const void* lengths, void* out, void* ws, int B,
        int Hkv, int G, int dh, int page_size, int npps, int n_valid,
        int pps, int n_split, int mma, float sm_scale, int bf16,
        void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || dh <= 0) return (int)cudaSuccess;
  const int isz = bf16 ? 2 : 4;
  const int chunks = (dh * isz + 15) / 16;        // 16-byte shares of a row
  int lg = 0;
  while ((1 << lg) < chunks && lg < 5) ++lg;
  const int nc = (chunks + 31) / 32;              // shares a lane holds
  if (nc > 4 || pps <= 0 || n_split <= 0 || (n_split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;            // a row takes <= 2048 bytes
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.table = (const int*)table;
  a.lengths = (const int*)lengths;
  a.out = out;
  a.ws = (float*)ws;
  a.rows = B * Hkv;
  a.Hkv = Hkv;
  a.G = G;
  a.dh = dh;
  a.page_size = page_size;
  a.npps = npps;
  a.n_valid = n_valid;
  a.pps = pps;
  a.n_split = n_split;
  a.lg = lg;
  if (mma && !(bf16 && page_size == MPAGE && (dh == 64 || dh == 128)))
    return (int)cudaErrorInvalidValue;            // a shape the route lacks
  a.vec = kind == HOT_ASYNC || mma
              ? copy_width(k, v, dh * isz)
              : (dh * isz) % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                    (uintptr_t)v % 16 == 0;
  a.sm_scale = sm_scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (mma)
    return dh == 64 ? launch_mma<64>(kind, a, st)
                    : launch_mma<128>(kind, a, st);
  // rows over 512 bytes: C chunks a lane, fewer heads a block, so the
  // registers a thread holds stay those of GM 8 at C 1
  if (nc > 2)
    return bf16 ? launch<__nv_bfloat16, 2, 4>(kind, a, st)
                : launch<float, 2, 4>(kind, a, st);
  if (nc > 1)
    return bf16 ? launch<__nv_bfloat16, 4, 2>(kind, a, st)
                : launch<float, 4, 2>(kind, a, st);
  if (bf16)
    return G <= 4 ? launch<__nv_bfloat16, 4, 1>(kind, a, st)
                  : launch<__nv_bfloat16, 8, 1>(kind, a, st);
  return G <= 4 ? launch<float, 4, 1>(kind, a, st)
                : launch<float, 8, 1>(kind, a, st);
}

}  // namespace

// Every entry point: q [B, Hkv, G, dh]; table int32 [B, npps]; lengths
// int32 [B]; out like q; ws f32, (B * Hkv * n_split * G * (dh + 2)) floats
// (unused, may be null, when n_split == 1); pps pages a split, n_split
// splits and mma (1: the tensor-core route), from the host's rules.

// flat pool [n_pages, page, Hkv, dh]; table entries are page ids
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* out, void* ws, int B, int Hkv, int G, int dh,
    int page_size, int npps, int n_pages, int pps, int n_split, int mma,
    float sm_scale, int bf16, void* stream) {
  return run(FLAT, q, k_pool, v_pool, table, lengths, out, ws, B, Hkv, G, dh,
             page_size, npps, n_pages, pps, n_split, mma, sm_scale, bf16,
             stream);
}

// per-stream hot pools [S, n_slots, page, Hkv, dh]; entries are slot ids
extern "C" int paged_attention_hot_slots_launch(
    const void* q, const void* k_hot, const void* v_hot, const void* table,
    const void* lengths, void* out, void* ws, int S, int Hkv, int G, int dh,
    int page_size, int npps, int n_slots, int pps, int n_split, int mma,
    float sm_scale, int bf16, void* stream) {
  return run(HOT, q, k_hot, v_hot, table, lengths, out, ws, S, Hkv, G, dh,
             page_size, npps, n_slots, pps, n_split, mma, sm_scale, bf16,
             stream);
}

// the same contract, the pages copied through a cp.async ring
extern "C" int paged_attention_hot_slots_async_launch(
    const void* q, const void* k_hot, const void* v_hot, const void* table,
    const void* lengths, void* out, void* ws, int S, int Hkv, int G, int dh,
    int page_size, int npps, int n_slots, int pps, int n_split, int mma,
    float sm_scale, int bf16, void* stream) {
  return run(HOT_ASYNC, q, k_hot, v_hot, table, lengths, out, ws, S, Hkv, G,
             dh, page_size, npps, n_slots, pps, n_split, mma, sm_scale, bf16,
             stream);
}
