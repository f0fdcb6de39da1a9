// Chunked SSD (state-space duality) scan for Hopper (sm_90a): the
// hand-written kernel behind repro_torch.kernels.ssd_scan.ssd_scan.
//
//   ssd_scan_f32 / ssd_scan_bf16  replace src/repro/kernels/ssd_scan.py
//                                 _ssd_kernel (the Pallas grid (BH, chunks)
//                                 with the state carried in VMEM scratch).
//
// Inputs: x (BH, T, P) and B, C (G, T, N) in one dtype (float32 or
// bfloat16), log_a (BH, T) float32.  G = BH / heads: with heads > 1 the B
// and C rows are shared by `heads` consecutive batch-heads (row bh reads
// B[bh / heads]), which is Mamba-2's layout on the model path; heads = 1 is
// the reference's (BH, T, N) signature.  T is a multiple of `chunk`.
// chunk is a multiple of 4, and of 32 when above 32 (whole row tiles); N
// and P are multiples of 16 bytes' worth of elements and x, B, C start on
// 16-byte boundaries (every load is 16 bytes wide).
// Output: y (BH, T, P) in x's dtype.  Per chunk, with la = cumsum(log_a):
//
//   y      = ((C B^T) * causal e^{la_t - la_s}) x + e^{la} * (C h)
//   h_new  = e^{la_last} h + (B * e^{la_last - la})^T x
//
// Every intermediate is float32, as the TPU kernel keeps it
// (preferred_element_type=float32 on float32 operands): the bf16 inputs are
// widened when they are staged, every product is a float32 FMA on the CUDA
// cores, and only y is rounded to the output dtype, once.  So the kernel and
// the plain version differ only in the order of float32 sums.
//
// What bounds it: operations.  At the model's shape (BH = 160 with B and C
// shared by H = 80 heads, T = 32768, P = 64, N = 128, chunk 128) one call
// moves about 1.4 GB (0.41 ms at 3.35 TB/s) and needs about 2.2e11
// float32 flops (3.2 ms at the 67 TFLOP/s of the float32 cores): the
// scores C B^T once per batch row, the rest per head.  The tensor cores
// would need a float32 intermediate rounded to bf16 or TF32, which the
// numerics contract refuses; that design is later work.
//
// Design.  Two kernels on one stream.
//   ssd_scores_kernel: G = C B^T of every chunk of every B/C row, into a
//     float32 scratch (chunk x chunk per chunk; 33.5 MB at the model's
//     shape, read back from L2): computed once for all the heads sharing
//     the row, 4x4 register tiles over the lower triangle.
//   ssd_scan_kernel: the TPU grid's sequential chunk axis becomes a loop
//     inside one block.  Block (bh, p-tile) owns 32 output channels of one
//     batch-head and walks its chunks in order, with its (N, 32) slice of
//     the state h in shared memory (y[:, p] and h[:, p] depend on x[:, p]
//     alone, so the channel tiles are independent).  Per chunk it stages
//     B^T, C^T (N x chunk, odd row stride chunk + 1, so neither the
//     transposing stores nor the column reads collide in a bank) and x
//     with 16-byte loads, takes the cumulative log-decay with one warp,
//     then walks the chunk in row tiles of 32: the score tile
//     G * e^{la_t - la_s} over s <= t only (never a positive exponent),
//     then y for the tile.  Last it scales B^T by the decay weights in
//     place and updates h in 4x4 register blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define PT 32      // output channels per block
#define RT_MAX 32  // rows of one score tile

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One 16-byte global load holds VEC<T> elements; widen() unpacks them.
template <typename T>
struct VEC {
  static constexpr int n = 16 / sizeof(T);
};
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

// Stages B^T and C^T of one chunk into shared memory (N x ld, float32)
// with 16-byte loads, UNROLL of them in flight per thread before any is
// unpacked (the staging is latency-bound).
template <typename T, int UNROLL>
__device__ __forceinline__ void stage_bc(const T* __restrict__ bg,
                                         const T* __restrict__ cg, float* bt,
                                         float* ct, int c0, int chunk,
                                         int n_dim, int ld, int tid) {
  constexpr int V = VEC<T>::n;
  const int nv = n_dim / V, total = chunk * nv;
  for (int base = tid; base < total; base += UNROLL * THREADS) {
    uint4 vb[UNROLL], vc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i < total) {
        const int s = i / nv;
        const size_t g = (size_t)(c0 + s) * n_dim + (i - s * nv) * V;
        vb[u] = *reinterpret_cast<const uint4*>(bg + g);
        vc[u] = *reinterpret_cast<const uint4*>(cg + g);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i < total) {
        const int s = i / nv, n0 = (i - s * nv) * V;
        float fb[V], fc[V];
        widen(vb[u], fb, T());
        widen(vc[u], fc, T());
#pragma unroll
        for (int k = 0; k < V; ++k) {
          bt[(n0 + k) * ld + s] = fb[k];
          ct[(n0 + k) * ld + s] = fc[k];
        }
      }
    }
  }
}

// The scores before the decay, G = C B^T (chunk x chunk, float32), of one
// chunk of one B/C row: the same for every batch-head sharing that row, so
// computed once for all of them.  4x4 register tiles over the lower
// triangle (tiles wholly above the diagonal are never read).  Block j of
// row g writes gm[(g * chunks + j) * chunk * chunk ...].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_scores_kernel(const T* __restrict__ b, const T* __restrict__ c,
                      float* __restrict__ gm, int t_len, int n_dim,
                      int chunk) {
  const int chunks = t_len / chunk;
  const int gi = blockIdx.x / chunks, j = blockIdx.x - gi * chunks;
  const int ld = chunk + 4, tid = threadIdx.x;
  extern __shared__ float4 smem4[];
  float* bt = reinterpret_cast<float*>(smem4);  // (N, ld) B^T
  float* ct = bt + n_dim * ld;                  // (N, ld) C^T
  const size_t off = (size_t)gi * t_len * n_dim;
  stage_bc<T, 4>(b + off, c + off, bt, ct, j * chunk, chunk, n_dim, ld, tid);
  __syncthreads();
  float* out = gm + ((size_t)gi * chunks + j) * chunk * chunk;
  const int groups = chunk / 4;
  for (int tile = tid; tile < groups * groups; tile += THREADS) {
    const int tr = (tile / groups) * 4, s0 = (tile % groups) * 4;
    if (s0 > tr + 3) continue;
    float acc[4][4] = {};
#pragma unroll 4
    for (int n = 0; n < n_dim; ++n) {
      const float4 cv = ld4(ct + n * ld + tr);
      const float4 bv = ld4(bt + n * ld + s0);
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(cr[i], br[k], acc[i][k]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(out + (tr + i) * chunk + s0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ log_a,
                    const T* __restrict__ b, const T* __restrict__ c,
                    const float* __restrict__ gm, T* __restrict__ y,
                    int t_len, int p_dim, int n_dim, int chunk, int heads,
                    int n_ptiles) {
  const int bh = blockIdx.x / n_ptiles;
  const int p0 = (blockIdx.x % n_ptiles) * PT;
  const int ld = chunk + 1;  // odd: transposing stores spread over banks
  const int rt = chunk < RT_MAX ? chunk : RT_MAX;
  const int tid = threadIdx.x;
  constexpr int V = VEC<T>::n;

  extern __shared__ float4 smem4[];
  float* bt = reinterpret_cast<float*>(smem4);  // (N, ld) B^T, then B^T * w
  float* ct = bt + n_dim * ld;                  // (N, ld) C^T
  float* xs = ct + n_dim * ld;                  // (chunk, PT)
  float* hs = xs + chunk * PT;                  // (N, PT) carried state
  float* ss = hs + n_dim * PT;                  // (rt, ld) score tile
  float* la = ss + rt * ld;                     // (chunk) cumsum of log_a

  const T* xg = x + (size_t)bh * t_len * p_dim;
  const float* lag = log_a + (size_t)bh * t_len;
  const size_t bc_off = (size_t)(bh / heads) * t_len * n_dim;
  const T* bg = b + bc_off;
  const T* cg = c + bc_off;
  T* yg = y + (size_t)bh * t_len * p_dim;

  for (int i = tid; i < n_dim * PT; i += THREADS) hs[i] = 0.f;

  for (int c0 = 0; c0 < t_len; c0 += chunk) {
    __syncthreads();  // the previous chunk is done with bt, xs and hs
    stage_bc<T, 4>(bg, cg, bt, ct, c0, chunk, n_dim, ld, tid);
    for (int i = tid; i < chunk * (PT / V); i += THREADS) {
      const int s = i / (PT / V), k = (i - s * (PT / V)) * V;
      float f[V];
      if (p0 + k < p_dim) {
        widen(*reinterpret_cast<const uint4*>(
                  xg + (size_t)(c0 + s) * p_dim + p0 + k),
              f, T());
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) xs[s * PT + k + j] = f[j];
    }
    for (int i = tid; i < chunk; i += THREADS) la[i] = lag[c0 + i];
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum: serial runs per lane, then a scan
      const int per = (chunk + 31) / 32;
      const int lo = tid * per, hi = min(lo + per, chunk);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += la[i];
        la[i] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - run;
      for (int i = lo; i < hi; ++i) la[i] += excl;
    }
    __syncthreads();

    const float* gc = gm + ((size_t)(bh / heads) * (t_len / chunk) +
                            c0 / chunk) * chunk * chunk;
    for (int r0 = 0; r0 < chunk; r0 += rt) {
      // scores for rows r0..r0+rt-1 over the columns s < r0 + rt: G
      // times the decay, formed for s <= t only
      const int ncols = r0 + rt;
#pragma unroll 4
      for (int i = tid; i < rt * ncols; i += THREADS) {
        const int tr = i / ncols, s = i - tr * ncols, t = r0 + tr;
        ss[tr * ld + s] =
            s <= t ? gc[t * chunk + s] * expf(la[t] - la[s]) : 0.f;
      }
      __syncthreads();
      // y for the rows of the tile: intra-chunk part + carried-state part
      for (int o = tid; o < rt * (PT / 4); o += THREADS) {
        const int tr = o / (PT / 4), pq = (o % (PT / 4)) * 4;
        const int t = r0 + tr;
        float a[4] = {}, hc[4] = {};
#pragma unroll 4
        for (int s = 0; s <= t; ++s) {
          const float sv = ss[tr * ld + s];
          const float4 xv = ld4(xs + s * PT + pq);
          a[0] = fmaf(sv, xv.x, a[0]);
          a[1] = fmaf(sv, xv.y, a[1]);
          a[2] = fmaf(sv, xv.z, a[2]);
          a[3] = fmaf(sv, xv.w, a[3]);
        }
#pragma unroll 4
        for (int n = 0; n < n_dim; ++n) {
          const float cv = ct[n * ld + t];
          const float4 hv = ld4(hs + n * PT + pq);
          hc[0] = fmaf(cv, hv.x, hc[0]);
          hc[1] = fmaf(cv, hv.y, hc[1]);
          hc[2] = fmaf(cv, hv.z, hc[2]);
          hc[3] = fmaf(cv, hv.w, hc[3]);
        }
        const float e = expf(la[t]);
        T* yr = yg + (size_t)(c0 + t) * p_dim;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + pq + j;
          if (p < p_dim) yr[p] = from_f<T>(a[j] + e * hc[j]);
        }
      }
      __syncthreads();
    }

    // the Merge: h = e^{la_last} h + (B * e^{la_last - la})^T x
    const float la_last = la[chunk - 1];
    for (int i = tid; i < n_dim * chunk; i += THREADS) {
      const int n = i / chunk, s = i - n * chunk;
      bt[n * ld + s] *= expf(la_last - la[s]);
    }
    __syncthreads();
    const float dec = expf(la_last);
    for (int tile = tid; tile < (n_dim / 4) * (PT / 4); tile += THREADS) {
      const int n0 = (tile / (PT / 4)) * 4, pq = (tile % (PT / 4)) * 4;
      float acc[4][4] = {};
#pragma unroll 4
      for (int s = 0; s < chunk; ++s) {
        const float4 xv = ld4(xs + s * PT + pq);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bw = bt[(n0 + i) * ld + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bw, xr[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* h = hs + (n0 + i) * PT + pq + j;
          *h = dec * *h + acc[i][j];
        }
    }
  }
}

// Shared memory one block needs, in bytes (kernels/ssd_scan.py mirrors it).
static size_t smem_bytes(int chunk, int n_dim) {
  const int ld = chunk + 1;
  const int rt = chunk < RT_MAX ? chunk : RT_MAX;
  return sizeof(float) *
         ((size_t)2 * n_dim * ld + (size_t)chunk * PT + (size_t)n_dim * PT +
          (size_t)rt * ld + chunk);
}

template <typename T>
static int launch(const T* x, const float* log_a, const T* b, const T* c,
                  float* gm, T* y, int bh, int t_len, int p_dim, int n_dim,
                  int chunk, int heads, cudaStream_t stream) {
  const size_t smem_g = sizeof(float) * 2 * (size_t)n_dim * (chunk + 4);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scores_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_g);
  if (e != cudaSuccess) return (int)e;
  ssd_scores_kernel<T><<<(bh / heads) * (t_len / chunk), THREADS, smem_g,
                         stream>>>(b, c, gm, t_len, n_dim, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes(chunk, n_dim);
  e = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_ptiles = (p_dim + PT - 1) / PT;
  ssd_scan_kernel<T><<<bh * n_ptiles, THREADS, smem, stream>>>(
      x, log_a, b, c, gm, y, t_len, p_dim, n_dim, chunk, heads, n_ptiles);
  return (int)cudaGetLastError();
}

// gm: float32 scratch of (BH / heads) * T * chunk elements for the scores.
extern "C" int ssd_scan_f32(const float* x, const float* log_a,
                            const float* b, const float* c, float* gm,
                            float* y, int bh, int t_len, int p_dim, int n_dim,
                            int chunk, int heads, void* stream) {
  return launch<float>(x, log_a, b, c, gm, y, bh, t_len, p_dim, n_dim, chunk,
                       heads, (cudaStream_t)stream);
}

extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* log_a,
                             const __nv_bfloat16* b, const __nv_bfloat16* c,
                             float* gm, __nv_bfloat16* y, int bh, int t_len,
                             int p_dim, int n_dim, int chunk, int heads,
                             void* stream) {
  return launch<__nv_bfloat16>(x, log_a, b, c, gm, y, bh, t_len, p_dim,
                               n_dim, chunk, heads, (cudaStream_t)stream);
}
