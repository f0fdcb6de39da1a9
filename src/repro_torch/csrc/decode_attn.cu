// Split-KV flash-decode attention for Hopper (sm_90a): the hand-written
// kernel behind repro_torch.kernels.decode_attn.decode_attention.
//
//   decode_attn_f32 / decode_attn_bf16  replace src/repro/kernels/
//                                       decode_attn.py _decode_attn_kernel
//                                       (the Pallas grid (BH, KV chunks)
//                                       with m, l, acc in VMEM scratch).
//
// Inputs: q (BH, G, D), k and v (BH, S, D), all float32 or all bfloat16,
// contiguous, starting on 16-byte boundaries, with D * sizeof(T) a multiple
// of 16 bytes (every K/V load is 16 bytes wide); G <= 16, D <= 256;
// kv_len (BH,) int32, clamped to [0, S].  Output: out (BH, G, D) in q's
// dtype.  One decode step of the G query heads sharing a KV head:
//
//   s   = (q . k_j) * scale  (scale = 1 / sqrt(D), applied after the dot)
//   out = sum_j softmax(s)_j v_j  over the positions j < kv_len
//
// with the TPU kernel's numerics: m, l and acc in float32; the
// unnormalised p = exp(s - m) rounded to v's dtype before p . v, while l
// sums the unrounded p; an all-masked tile guarded so it adds nothing; out
// = acc / max(l, 1e-30), so kv_len = 0 gives zeros.
//
// What bounds it: bytes.  The function needs K and V up to each row's
// kv_len once, q once and out once.  At decode_32k with qwen3-14b's heads
// (BH = 128 x 8, G = 5, D = 128, S = 32768, bf16) that is 17.2 GB at full
// length, 5.13 ms at 3.35 TB/s, against about 4 G D sum(kv_len) = 8.6e10
// float32 flops (1.3 ms on the float32 cores).
//
// Design: split-KV flash-decoding.  The TPU walks one row's chunks in
// order on one core; here each row's [0, kv_len) is cut into splits of
// `split` positions and the grid is (splits, BH), so a short batch still
// fills the 132 SMs.  Splits at or past kv_len exit at once: the reference
// reads and masks those positions, skipping them is the same function and
// is where the bound's bytes come from.  A block (128 threads) walks its
// split in tiles of tk positions, the largest power of two up to
// min(128, 16 KB / (D * sizeof(T))):
//   1. stages the K and V tile in shared memory with 16-byte loads, all of
//      a thread's loads in flight before any store; rows past kv_len are
//      staged as zeros.  The row stride is padded by 16 bytes per thread
//      that shares a key in step 2, so the 16-byte reads of one phase of
//      8 lanes land in 8 different groups of 4 banks;
//   2. scores: the 128 / tk threads of a key (adjacent lanes) each take
//      every (128 / tk)-th 16-byte vector of the key's row, against q
//      widened to float32 in shared memory, for all G heads at
//      once: each K row is read once for the whole GQA group;
//   3. one warp per head takes the tile's max, updates m, forms p against
//      the new m, rounds it to T, and sums the unrounded p into l;
//   4. p . v: each thread owns one (two for D > 128) output columns of all
//      G heads in registers, rescales them by alpha and accumulates the
//      tile (p read four positions at a time, broadcast).
// Each block writes its partial (m, l, acc).  A second launch merges the
// splits of a row by log-sum-exp: M = max m_i, l = sum l_i e^{m_i - M},
// acc = sum acc_i e^{m_i - M}, out = acc / max(l, 1e-30).  That is exactly
// softmax_aggregate's Merge (src/repro/models/attention.py:119), the
// reference's sequence-parallel combine.
//
// A split's running max is not the sequential kernel's, so the bf16
// rounding of p differs from the plain version by about 1e-3 relative in
// bf16 (and only in summation order in float32).  The CUDA cores do the
// arithmetic in float32; wgmma and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode_attn.so decode_attn.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 128
#define WARPS (THREADS / 32)
#define TILE_BYTES 16384  // bytes of K (and of V) one tile stages at most
#define MAXV (TILE_BYTES / 16 / THREADS)  // 16-byte loads a thread stages

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One 16-byte load holds 16 / sizeof(T) elements; widen() unpacks them.
__device__ __forceinline__ void widen(const uint4 v, float* f, float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(const uint4 v, float* f,
                                      __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ int clamp_len(const int* kv_len, int row,
                                         int s_len) {
  const int len = kv_len[row];
  return len < 0 ? 0 : (len > s_len ? s_len : len);
}

// Shared memory of one split block, in bytes (kernels/decode_attn.py
// mirrors it): K and V tiles (tk rows of D * sizeof(T) + 16 * tpk bytes),
// q widened (G x D float32), scores / p (G x tk) and m, l, alpha (3 x 16).
static size_t smem_bytes(int tk, int g_n, int d, int esize) {
  const int tpk = THREADS / tk;
  const size_t rb = (size_t)d * esize + 16 * tpk;
  return 2 * tk * rb + sizeof(float) * ((size_t)g_n * d + (size_t)g_n * tk +
                                        3 * 16);
}

template <typename T, int GM, int DPT>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len, float* pm, float* pl,
                        float* pacc, int s_len, int g_n, int d, int split,
                        int n_split, int tk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const int len = clamp_len(kv_len, row, s_len);
  const int start = sp * split;
  if (start >= len) return;  // the merge reads no partial of this split
  const int end = min(start + split, len);

  constexpr int V = 16 / sizeof(T);
  const int tpk = THREADS / tk;     // threads per key in the score step
  const int rb = d * (int)sizeof(T) + 16 * tpk;  // staged row stride, bytes
  const int vr = d / V;             // 16-byte vectors per row
  unsigned char* ks = smem;
  unsigned char* vs = ks + tk * rb;
  float* qs = reinterpret_cast<float*>(vs + tk * rb);  // G x D
  float* ps = qs + g_n * d;                            // G x tk
  float* st = ps + g_n * tk;  // m [0, 16), l [16, 32), alpha [32, 48)

  const T* qg = q + (size_t)row * g_n * d;
  for (int i = tid; i < g_n * d; i += THREADS) qs[i] = to_f(qg[i]);
  if (tid < g_n) {
    st[tid] = -INFINITY;
    st[16 + tid] = 0.f;
  }
  float acc[GM][DPT];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[g][c] = 0.f;
  const size_t base = (size_t)row * s_len;
  const int kk = tid / tpk, part = tid - kk * tpk;
  const int lane = tid & 31, warp = tid >> 5;
  const int nvec = tk * vr;
  __syncthreads();

  for (int t0 = start; t0 < end; t0 += tk) {
    // 1. stage K and V rows [t0, t0 + tk); rows at or past end are zeros
    uint4 kb[MAXV], vb[MAXV];
#pragma unroll
    for (int u = 0; u < MAXV; ++u) {
      const int i = tid + u * THREADS;
      kb[u] = vb[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nvec) {
        const int r = i / vr, c = i - r * vr;
        if (t0 + r < end) {
          const size_t off = (base + t0 + r) * d + (size_t)c * V;
          kb[u] = __ldg(reinterpret_cast<const uint4*>(k + off));
          vb[u] = __ldg(reinterpret_cast<const uint4*>(v + off));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MAXV; ++u) {
      const int i = tid + u * THREADS;
      if (i < nvec) {
        const int r = i / vr, c = i - r * vr;
        *reinterpret_cast<uint4*>(ks + r * rb + c * 16) = kb[u];
        *reinterpret_cast<uint4*>(vs + r * rb + c * 16) = vb[u];
      }
    }
    __syncthreads();

    // 2. scores of key kk for every head, reduced over its tpk threads
    {
      float dot[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) dot[g] = 0.f;
      const unsigned char* krow = ks + kk * rb;
      for (int c = part; c < vr; c += tpk) {
        float kf[V];
        widen(*reinterpret_cast<const uint4*>(krow + c * 16), kf, T());
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < g_n) {
            const float* qp = qs + g * d + c * V;
#pragma unroll
            for (int e = 0; e < V; e += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qp + e);
              dot[g] = fmaf(q4.x, kf[e], dot[g]);
              dot[g] = fmaf(q4.y, kf[e + 1], dot[g]);
              dot[g] = fmaf(q4.z, kf[e + 2], dot[g]);
              dot[g] = fmaf(q4.w, kf[e + 3], dot[g]);
            }
          }
        }
      }
      for (int o = tpk / 2; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
      if (part == 0) {
        const bool live = t0 + kk < end;
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < g_n) ps[g * tk + kk] = live ? dot[g] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // 3. per head: tile max, new m, p rounded to T, l from the unrounded p
    for (int g = warp; g < g_n; g += WARPS) {
      float* pr = ps + g * tk;
      float mx = -INFINITY;
      for (int j = lane; j < tk; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = st[g];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int j = lane; j < tk; j += 32) {
        const float s = pr[j];
        const float p = isfinite(s) ? expf(s - m_safe) : 0.f;
        sum += p;
        pr[j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = isfinite(m_old) ? expf(m_old - m_safe) : 0.f;
        st[g] = m_new;
        st[16 + g] = st[16 + g] * alpha + sum;
        st[32 + g] = alpha;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p . v for this thread's columns
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < g_n) {
        const float a = st[32 + g];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[g][c] *= a;
      }
    }
    for (int j = 0; j < tk; j += 4) {
      float vv[4][DPT];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const T* vrow = reinterpret_cast<const T*>(vs + (j + jj) * rb);
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const int col = tid + c * THREADS;
          vv[jj][c] = col < d ? to_f(vrow[col]) : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < g_n) {
          const float4 p4 = *reinterpret_cast<const float4*>(ps + g * tk + j);
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            float a = acc[g][c];
            a = fmaf(p4.x, vv[0][c], a);
            a = fmaf(p4.y, vv[1][c], a);
            a = fmaf(p4.z, vv[2][c], a);
            a = fmaf(p4.w, vv[3][c], a);
            acc[g][c] = a;
          }
        }
      }
    }
    __syncthreads();
  }

  const size_t pidx = (size_t)row * n_split + sp;
  if (tid < g_n) {
    pm[pidx * g_n + tid] = st[tid];
    pl[pidx * g_n + tid] = st[16 + tid];
  }
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < g_n) {
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tid + c * THREADS;
        if (col < d) pacc[(pidx * g_n + g) * d + col] = acc[g][c];
      }
    }
  }
}

// The log-sum-exp merge of a row's splits (softmax_aggregate's Merge),
// then Terminate: out = acc / max(l, 1e-30); a row with kv_len = 0 has no
// split and gives zeros.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_merge_kernel(const int* __restrict__ kv_len,
                        const float* __restrict__ pm,
                        const float* __restrict__ pl,
                        const float* __restrict__ pacc, T* __restrict__ out,
                        int s_len, int g_n, int d, int split, int n_split) {
  const int row = blockIdx.x;
  const int len = clamp_len(kv_len, row, s_len);
  const int n = (len + split - 1) / split;
  const size_t b0 = (size_t)row * n_split;
  for (int i = threadIdx.x; i < g_n * d; i += THREADS) {
    const int g = i / d, col = i - g * d;
    float o = 0.f;
    if (n > 0) {
      float mx = -INFINITY;
      for (int s = 0; s < n; ++s) mx = fmaxf(mx, pm[(b0 + s) * g_n + g]);
      float l = 0.f, a = 0.f;
      for (int s = 0; s < n; ++s) {
        const size_t j = (b0 + s) * g_n + g;
        const float w = expf(pm[j] - mx);
        l = fmaf(pl[j], w, l);
        a = fmaf(pacc[j * d + col], w, a);
      }
      o = a / fmaxf(l, 1e-30f);
    }
    out[(size_t)row * g_n * d + i] = from_f<T>(o);
  }
}

template <typename T, int GM, int DPT>
static int launch_split(const T* q, const T* k, const T* v,
                        const int* kv_len, float* pm, float* pl, float* pacc,
                        int bh, int s_len, int g_n, int d, int split,
                        int n_split, int tk, float scale,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes(tk, g_n, d, (int)sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<T, GM, DPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  decode_split_kernel<T, GM, DPT><<<dim3(n_split, bh), THREADS, smem,
                                    stream>>>(q, k, v, kv_len, pm, pl, pacc,
                                              s_len, g_n, d, split, n_split,
                                              tk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* q, const T* k, const T* v, const int* kv_len,
                  float* pm, float* pl, float* pacc, T* out, int bh,
                  int s_len, int g_n, int d, int split, int tk, float scale,
                  cudaStream_t stream) {
  const int n_split = (s_len + split - 1) / split;
  int err;
  if (g_n <= 8)
    err = d <= THREADS
              ? launch_split<T, 8, 1>(q, k, v, kv_len, pm, pl, pacc, bh,
                                      s_len, g_n, d, split, n_split, tk,
                                      scale, stream)
              : launch_split<T, 8, 2>(q, k, v, kv_len, pm, pl, pacc, bh,
                                      s_len, g_n, d, split, n_split, tk,
                                      scale, stream);
  else
    err = d <= THREADS
              ? launch_split<T, 16, 1>(q, k, v, kv_len, pm, pl, pacc, bh,
                                       s_len, g_n, d, split, n_split, tk,
                                       scale, stream)
              : launch_split<T, 16, 2>(q, k, v, kv_len, pm, pl, pacc, bh,
                                       s_len, g_n, d, split, n_split, tk,
                                       scale, stream);
  if (err != 0) return err;
  decode_merge_kernel<T><<<bh, THREADS, 0, stream>>>(
      kv_len, pm, pl, pacc, out, s_len, g_n, d, split, n_split);
  return (int)cudaGetLastError();
}

// pm, pl: float32 scratch of BH * ceil(S / split) * G elements; pacc of
// that times D.  tk is the largest power of two up to min(128, 16384 /
// (D * sizeof(T))) and split a multiple of it (kernels/decode_attn.py
// computes both).
extern "C" int decode_attn_f32(const float* q, const float* k, const float* v,
                               const int* kv_len, float* pm, float* pl,
                               float* pacc, float* out, int bh, int s_len,
                               int g_n, int d, int split, int tk, float scale,
                               void* stream) {
  return launch<float>(q, k, v, kv_len, pm, pl, pacc, out, bh, s_len, g_n, d,
                       split, tk, scale, (cudaStream_t)stream);
}

extern "C" int decode_attn_bf16(const __nv_bfloat16* q,
                                const __nv_bfloat16* k,
                                const __nv_bfloat16* v, const int* kv_len,
                                float* pm, float* pl, float* pacc,
                                __nv_bfloat16* out, int bh, int s_len,
                                int g_n, int d, int split, int tk,
                                float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, pm, pl, pacc, out, bh, s_len,
                               g_n, d, split, tk, scale,
                               (cudaStream_t)stream);
}
