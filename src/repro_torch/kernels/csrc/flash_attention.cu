// Flash-attention forward (GQA prefill) for Hopper.
//
// Replaces the Pallas TPU kernel flash_attention_fwd (_flash_kernel) of
// src/repro/kernels/flash_attention/kernel.py: q [B, Hq, Sq, dh] against
// k, v [B, Hkv, Sk, dh], query head h reading KV head h / G (G = Hq / Hkv)
// with no broadcast copy; causal (key <= query) and sliding-window
// (key > query - window) masks, the query at row i standing at position
// i + q_offset; float32 or bfloat16 in and out, every statistic in float32.
//
// The TPU kernel walks KV blocks on a sequential grid axis with (m, l, acc)
// in VMEM scratch. Here one block of THREADS threads owns BQ query rows of
// one (batch, query head) and loops over the KV tiles of BK keys its mask
// can reach; the loop takes the place of the sequential grid axis, and the
// online-softmax state stays in registers. Tiles wholly outside the mask
// are skipped: the reference's update leaves (m, l, acc) unchanged on such
// a tile, so skipping is exact.
//
// Per tile, as _flash_kernel: s = (q * sm_scale) . k, masked to -1e30;
// m_new = max(m, rowmax s); m_safe = (m_new <= -1e30 / 2) ? 0 : m_new;
// p = masked ? 0 : expf(s - m_safe); corr = (m <= -1e30 / 2) ? 0 :
// expf(m - m_safe); l = l * corr + sum p; acc = acc * corr + p . v; and at
// the end o = acc / max(l, 1e-30) (a fully masked row gives 0).
//
// Thread mapping: 4 threads per query row (BQ = 32 rows x 4 = 128 threads).
// A thread computes the scores of its row for keys sub, sub + 4, ... of the
// tile, the row's max and sum go through two xor shuffles among the four,
// the probabilities pass through shared memory, and the thread accumulates
// output columns sub, sub + 4, ... (C of them, C = DH_MAX / 4 registers).
// Q and K tiles are stored with a row pitch of dh + 1 floats so that the
// score loop reads distinct banks.
//
// Tensors are addressed through element strides (batch, head, sequence);
// dh must be contiguous. So the model's [B, S, H, dh] layout is read in
// place and the output written in the caller's layout.
//
// Bound: operations -- 4 * dh flops per unmasked (query, key) pair per
// query head. This first kernel runs them on the CUDA cores in float32,
// far from the tensor-core rate that bound assumes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 32;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int KPT = BK / 4;  // scores per thread per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;
};

__host__ __device__ inline size_t smem_floats(int dh) {
  return (size_t)BQ * (dh + 1) + (size_t)BK * (dh + 1) + (size_t)BK * dh +
         (size_t)BQ * (BK + 1);
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int G,
             int Sq, int Sk, int dh, int causal, Strides qs, Strides ks,
             Strides vs, Strides os, int window, int q_offset,
             float sm_scale) {
  extern __shared__ float smem[];
  const int LQ = dh + 1, LK = dh + 1, LP = BK + 1;
  float* Qs = smem;                 // [BQ][LQ]
  float* Ks = Qs + BQ * LQ;         // [BK][LK]
  float* Vs = Ks + BK * LK;         // [BK][dh]
  float* Ps = Vs + BK * dh;         // [BQ][LP]

  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * dh; i += THREADS) {
    const int row = i / dh, d = i - row * dh;
    const int qr = q0 + row;
    Qs[row * LQ + d] =
        qr < Sq ? to_f32(qb[(long long)qr * qs.s + d]) * sm_scale : 0.f;
  }

  // the key range this block's mask can reach
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_last + q_offset + 1);
  if (window) k_begin = max(0, q0 + q_offset - window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  const int qpos = q0 + r + q_offset;
  float m = NEG_INF, l = 0.f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Q is stored; the previous tile is no longer read
    for (int i = tid; i < BK * dh; i += THREADS) {
      const int row = i / dh, d = i - row * dh;
      const int kr = k0 + row;
      const bool in = kr < Sk;
      Ks[row * LK + d] = in ? to_f32(kb[(long long)kr * ks.s + d]) : 0.f;
      Vs[row * dh + d] = in ? to_f32(vb[(long long)kr * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float qd = Qs[r * LQ + d];
#pragma unroll
      for (int i = 0; i < KPT; ++i) s[i] += qd * Ks[(sub + 4 * i) * LK + d];
    }
    float mt = NEG_INF;
    unsigned ok = 0;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kp = k0 + sub + 4 * i;
      const bool in = kp < Sk && (!causal || kp <= qpos) &&
                      (!window || kp > qpos - window);
      ok |= (unsigned)in << i;
      s[i] = in ? s[i] : NEG_INF;
      mt = fmaxf(mt, s[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = (ok >> i) & 1u ? expf(s[i] - m_safe) : 0.f;
      Ps[r * LP + sub + 4 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = m <= NEG_INF / 2 ? 0.f : expf(m - m_safe);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's four threads (one warp) see each other's p
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= corr;
    for (int j = 0; j < BK; ++j) {
      const float p = Ps[r * LP + j];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = sub + 4 * c;
        if (col < dh) acc[c] += p * Vs[j * dh + col];
      }
    }
  }

  const int qr = q0 + r;
  if (qr < Sq) {
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    T* ob = o + b * os.b + h * os.h + (long long)qr * os.s;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = sub + 4 * c;
      if (col < dh) store(ob + col, acc[c] * inv_l);
    }
  }
}

template <typename T, int C>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int dh, int causal, Strides qs,
           Strides ks, Strides vs, Strides os, int window, int q_offset,
           float sm_scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(dh);
  auto kern = flash_kernel<T, C>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hq / Hkv, Sq, Sk, dh,
      causal, qs, ks, vs, os, window, q_offset, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Sk, int dh, int causal, Strides qs,
             Strides ks, Strides vs, Strides os, int window, int q_offset,
             float sm_scale, cudaStream_t st) {
  if (dh <= 64)
    return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, dh, causal, qs, ks,
                         vs, os, window, q_offset, sm_scale, st);
  if (dh <= 128)
    return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, dh, causal, qs, ks,
                         vs, os, window, q_offset, sm_scale, st);
  return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, dh, causal, qs, ks,
                       vs, os, window, q_offset, sm_scale, st);
}

}  // namespace

// Strides are in elements, (batch, head, sequence) for each of q, k, v, o.
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// head dim outside (0, 256] or query heads that KV heads do not divide.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Sk, int dh, int causal, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int window, int q_offset,
    float sm_scale, int bf16, void* stream) {
  if (dh <= 0 || dh > 256 || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hq <= 0 || Sq <= 0) return (int)cudaSuccess;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, dh, causal,
                                   qs, ks, vs, os, window, q_offset, sm_scale,
                                   st);
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, dh, causal, qs, ks,
                         vs, os, window, q_offset, sm_scale, st);
}
