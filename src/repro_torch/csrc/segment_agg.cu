// Fused segment aggregation for Hopper (sm_90a): the two hand-written
// kernels behind repro_torch.kernels.segment_agg.fused_segment_agg.
//
//   segagg_unsorted  replaces src/repro/kernels/segment_agg.py
//                    _segment_agg_kernel (the cross-product grid that
//                    carries the sort-free route, layout="unsorted").
//   segagg_sorted    replaces src/repro/kernels/segment_agg.py
//                    _segment_agg_kernel_pruned (the band-pruned grid that
//                    carries the sorted route).
//
// Both compute, per segment s and value column c, the moments
//   row 0 sum, row 1 count, row 2 min, row 3 max
// and, when any column asks for an index moment, row 4 (argmin row index)
// and row 5 (argmax row index) with first- or last-attaining tie order,
// into a (C, R, S) float32 tensor with the identities 0, 0, +inf, -inf and
// the tie identity (+inf first, -inf last) where no valid row lands.
//
// What bounds them: bytes.  Each reads N*C*(4+1) bytes of values and
// validity and 4N bytes of segment ids, and writes C*R*S*4 bytes; the work
// per byte is a handful of integer ops.  The one-hot membership masks and
// 128-lane segment tiles of the TPU kernels are gone: a row touches only
// its own segment's output.
//
//   * unsorted: one pass of global atomics.  Sum and count are atomicAdd;
//     min and max are atomicMin/atomicMax on order-preserving u32 encodings
//     of the f32 bits; each index row is ONE 64-bit atomicMin/atomicMax on
//     the packed word (ordered_key << 32) | row_part, where row_part is the
//     row (or its complement, when the tie order asks for the largest row),
//     so the lexicographic (key, row) compare of the TPU kernel is a single
//     integer compare.  The atomics' traffic stays in L2 for the bounded
//     segment ranges of the sort-free route.
//   * sorted: each warp owns a contiguous range of rows and walks it in
//     32-row chunks with a warp-level segmented inclusive scan (shuffles),
//     carrying the open run from chunk to chunk.  A run is emitted once, at
//     its last row: with a plain store when the segment lies wholly inside
//     the warp's range, with the same atomics as above when it crosses the
//     range's first or last row.  So the atomics fall to at most two per
//     warp range and moment; the rest of the output is written once.
//
// Each accumulate kernel is bracketed by a fill kernel (identities, in
// encoded form) and a finalize kernel (decodes min/max bits and the index
// words to f32).  NaN: a valid NaN value makes its segment's min and max
// NaN, and its index rows the tie identity (no row attains a NaN extremum),
// as the plain version does.  -0.0 orders below +0.0 for min and max; the
// index key compares -0.0 equal to +0.0, so the tie order decides.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsegagg.so segment_agg.cu
#include <cuda_runtime.h>
#include <stdint.h>

#define MAXC 32

// per-column request bits (must match kernels/segment_agg.py _col_flags)
#define F_SUM 1
#define F_CNT 2
#define F_MIN 4
#define F_MAX 8
#define F_AMIN 16        // argmin requested
#define F_AMIN_FIRST 32  // ... with first-attaining tie order
#define F_AMAX 64
#define F_AMAX_FIRST 128

struct ColFlags {
  int f[MAXC];
};

typedef unsigned long long u64;

// order-preserving u32 encoding of f32 bits: a < b as floats (with -0 < +0)
// iff enc(a) < enc(b) as unsigned.  enc(-inf) = 0x007FFFFF, enc(+inf) =
// 0xFF800000; every non-NaN value lies between, so 0 and 0xFFFFFFFF are
// free to stand for NaN in the min and max directions.
__device__ __forceinline__ unsigned enc(float v) {
  unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float dec(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

#define ENC_POS_INF 0xFF800000u
#define ENC_NEG_INF 0x007FFFFFu
#define NAN_MIN 0u
#define NAN_MAX 0xFFFFFFFFu
#define CANON_NAN 0x7FC00000u
#define WORD_MIN_INIT 0xFFFFFFFFFFFFFFFFull
#define WORD_MAX_INIT 0ull

__device__ __forceinline__ unsigned enc_min(float v) {
  return isnan(v) ? NAN_MIN : enc(v);
}
__device__ __forceinline__ unsigned enc_max(float v) {
  return isnan(v) ? NAN_MAX : enc(v);
}
// index-moment word: key compares -0.0 equal to +0.0
__device__ __forceinline__ u64 amin_word(float v, unsigned row, bool first) {
  unsigned k = isnan(v) ? NAN_MIN : enc(v == 0.0f ? 0.0f : v);
  return ((u64)k << 32) | (first ? row : ~row);
}
__device__ __forceinline__ u64 amax_word(float v, unsigned row, bool first) {
  unsigned k = isnan(v) ? NAN_MAX : enc(v == 0.0f ? 0.0f : v);
  return ((u64)k << 32) | (first ? ~row : row);
}

__global__ void fill_kernel(float* out, u64* idxw, int ncols, int nrows,
                            long long nseg) {
  long long total = (long long)ncols * nrows * nseg;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int r = (int)((i / nseg) % nrows);
    unsigned v = 0u;                       // sum, count: +0.0
    if (r == 2) v = ENC_POS_INF;
    if (r == 3) v = ENC_NEG_INF;
    reinterpret_cast<unsigned*>(out)[i] = v;
  }
  if (idxw == nullptr) return;
  long long wtotal = (long long)ncols * 2 * nseg;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < wtotal; i += stride) {
    int j = (int)((i / nseg) % 2);
    idxw[i] = j == 0 ? WORD_MIN_INIT : WORD_MAX_INIT;
  }
}

__global__ void finalize_kernel(float* out, const u64* idxw, ColFlags flags,
                                int ncols, int nrows, long long nseg) {
  long long total = (long long)ncols * nrows * nseg;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    long long s = i % nseg;
    int r = (int)((i / nseg) % nrows);
    int c = (int)(i / (nseg * nrows));
    if (r == 2 || r == 3) {
      unsigned u = reinterpret_cast<unsigned*>(out)[i];
      bool nan = r == 2 ? u == NAN_MIN : u == NAN_MAX;
      out[i] = nan ? __uint_as_float(CANON_NAN) : dec(u);
    } else if (r >= 4) {
      int f = flags.f[c];
      bool amin = r == 4;
      bool req = f & (amin ? F_AMIN : F_AMAX);
      bool first = f & (amin ? F_AMIN_FIRST : F_AMAX_FIRST);
      float ident = (req && !first) ? -INFINITY : INFINITY;
      float res = ident;
      if (req) {
        u64 w = idxw[((long long)c * 2 + (amin ? 0 : 1)) * nseg + s];
        unsigned k = (unsigned)(w >> 32);
        bool empty = w == (amin ? WORD_MIN_INIT : WORD_MAX_INIT);
        bool nan = k == (amin ? NAN_MIN : NAN_MAX);
        unsigned part = (unsigned)w;
        unsigned row = (amin == first) ? part : ~part;
        if (!empty && !nan) res = (float)row;
      }
      out[i] = res;
    }
  }
}

// ---------------------------------------------------------------------------
// segagg_unsorted: segment ids in any order, global atomics
// ---------------------------------------------------------------------------

__global__ void unsorted_kernel(const float* __restrict__ vals,
                                const int* __restrict__ segs,
                                const unsigned char* __restrict__ valid,
                                float* out, u64* idxw, ColFlags flags,
                                long long n, int ncols, int nrows,
                                long long nseg) {
  const int c = blockIdx.y;
  const int f = flags.f[c];
  float* base = out + (long long)c * nrows * nseg;
  unsigned* ubase = reinterpret_cast<unsigned*>(base);
  u64* wbase = idxw == nullptr ? nullptr : idxw + (long long)c * 2 * nseg;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    int s = segs[r];
    if (s < 0 || s >= nseg || !valid[r * ncols + c]) continue;
    float v = vals[r * ncols + c];
    if (f & F_SUM) atomicAdd(base + s, v);
    if (f & F_CNT) atomicAdd(base + nseg + s, 1.0f);
    if (f & F_MIN) atomicMin(ubase + 2 * nseg + s, enc_min(v));
    if (f & F_MAX) atomicMax(ubase + 3 * nseg + s, enc_max(v));
    if (f & F_AMIN)
      atomicMin(wbase + s, amin_word(v, (unsigned)r, f & F_AMIN_FIRST));
    if (f & F_AMAX)
      atomicMax(wbase + nseg + s, amax_word(v, (unsigned)r, f & F_AMAX_FIRST));
  }
}

// ---------------------------------------------------------------------------
// segagg_sorted: segment ids sorted ascending, warp segmented scan
// ---------------------------------------------------------------------------

// rows one warp walks (32-row chunks); big enough that the two boundary
// runs per range are a small share of the emissions
#define WARP_ROWS 1024

struct Acc {
  float sum, cnt;
  unsigned mn, mx;
  u64 amin, amax;
};

__device__ __forceinline__ Acc acc_identity() {
  Acc a;
  a.sum = 0.0f;
  a.cnt = 0.0f;
  a.mn = ENC_POS_INF;
  a.mx = ENC_NEG_INF;
  a.amin = WORD_MIN_INIT;
  a.amax = WORD_MAX_INIT;
  return a;
}

// o is the earlier part of the run, a the later one
__device__ __forceinline__ Acc combine(const Acc& o, const Acc& a) {
  Acc r;
  r.sum = o.sum + a.sum;
  r.cnt = o.cnt + a.cnt;
  r.mn = min(o.mn, a.mn);
  r.mx = max(o.mx, a.mx);
  r.amin = min(o.amin, a.amin);
  r.amax = max(o.amax, a.amax);
  return r;
}

__device__ __forceinline__ Acc shfl_up(const Acc& a, int d) {
  const unsigned m = 0xFFFFFFFFu;
  Acc r;
  r.sum = __shfl_up_sync(m, a.sum, d);
  r.cnt = __shfl_up_sync(m, a.cnt, d);
  r.mn = __shfl_up_sync(m, a.mn, d);
  r.mx = __shfl_up_sync(m, a.mx, d);
  r.amin = __shfl_up_sync(m, a.amin, d);
  r.amax = __shfl_up_sync(m, a.amax, d);
  return r;
}

__device__ __forceinline__ Acc shfl_idx(const Acc& a, int lane) {
  const unsigned m = 0xFFFFFFFFu;
  Acc r;
  r.sum = __shfl_sync(m, a.sum, lane);
  r.cnt = __shfl_sync(m, a.cnt, lane);
  r.mn = __shfl_sync(m, a.mn, lane);
  r.mx = __shfl_sync(m, a.mx, lane);
  r.amin = __shfl_sync(m, a.amin, lane);
  r.amax = __shfl_sync(m, a.amax, lane);
  return r;
}

__device__ __forceinline__ void emit(const Acc& a, int f, long long s,
                                     float* base, u64* wbase, long long nseg,
                                     bool shared) {
  unsigned* ubase = reinterpret_cast<unsigned*>(base);
  if (shared) {
    if (f & F_SUM) atomicAdd(base + s, a.sum);
    if (f & F_CNT) atomicAdd(base + nseg + s, a.cnt);
    if (f & F_MIN) atomicMin(ubase + 2 * nseg + s, a.mn);
    if (f & F_MAX) atomicMax(ubase + 3 * nseg + s, a.mx);
    if (f & F_AMIN) atomicMin(wbase + s, a.amin);
    if (f & F_AMAX) atomicMax(wbase + nseg + s, a.amax);
  } else {
    // the identity fill left +0.0 here: adding it keeps a run of -0.0
    // values summing to +0.0, as the atomic path and the plain version do
    if (f & F_SUM) base[s] = 0.0f + a.sum;
    if (f & F_CNT) base[nseg + s] = a.cnt;
    if (f & F_MIN) ubase[2 * nseg + s] = a.mn;
    if (f & F_MAX) ubase[3 * nseg + s] = a.mx;
    if (f & F_AMIN) wbase[s] = a.amin;
    if (f & F_AMAX) wbase[nseg + s] = a.amax;
  }
}

__global__ void sorted_kernel(const float* __restrict__ vals,
                              const int* __restrict__ segs,
                              const unsigned char* __restrict__ valid,
                              float* out, u64* idxw, ColFlags flags,
                              long long n, int ncols, int nrows,
                              long long nseg) {
  const int c = blockIdx.y;
  const int f = flags.f[c];
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long begin = warp * WARP_ROWS;
  if (begin >= n) return;                       // whole warp leaves together
  const long long end = min(begin + (long long)WARP_ROWS, n);
  float* base = out + (long long)c * nrows * nseg;
  u64* wbase = idxw == nullptr ? nullptr : idxw + (long long)c * 2 * nseg;

  // runs that continue past either end of the range are shared with the
  // neighbouring warp: those are emitted with atomics
  const int first_seg = segs[begin];
  const bool first_shared = begin > 0 && segs[begin - 1] == first_seg;
  const int last_seg = segs[end - 1];
  const bool last_shared = end < n && segs[end] == last_seg;

  Acc carry = acc_identity();
  int carry_seg = 0;
  bool has_carry = false;
  for (long long chunk = begin; chunk < end; chunk += 32) {
    const long long r = chunk + lane;
    const bool in = r < end;
    const int s = in ? segs[r] : -1;
    Acc a = acc_identity();
    if (in && s >= 0 && s < nseg && valid[r * ncols + c]) {
      const float v = vals[r * ncols + c];
      a.sum = v;
      a.cnt = 1.0f;
      a.mn = enc_min(v);
      a.mx = enc_max(v);
      a.amin = amin_word(v, (unsigned)r, f & F_AMIN_FIRST);
      a.amax = amax_word(v, (unsigned)r, f & F_AMAX_FIRST);
    }
    // inclusive segmented scan: segments are contiguous, so equal ids at
    // both ends of a shuffle distance mean one run in between
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      Acc o = shfl_up(a, d);
      int os = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d && os == s) a = combine(o, a);
    }
    if (has_carry && in && s == carry_seg) a = combine(carry, a);
    // a lane ends its run when the next row (within the range) differs
    const int next = __shfl_down_sync(0xFFFFFFFFu, s, 1);
    bool is_end = false;
    if (in) {
      if (r + 1 >= end) is_end = true;
      else if (lane == 31) is_end = segs[r + 1] != s;
      else is_end = next != s;
    }
    if (is_end && s >= 0 && s < nseg) {
      bool shared = (s == first_seg && first_shared) ||
                    (s == last_seg && last_shared);
      emit(a, f, s, base, wbase, nseg, shared);
    }
    const bool end31 = __shfl_sync(0xFFFFFFFFu, is_end, 31);
    carry = shfl_idx(a, 31);
    carry_seg = __shfl_sync(0xFFFFFFFFu, s, 31);
    has_carry = !end31;
  }
}

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  Each entry point fills, accumulates and
// finalizes on `stream` and returns the first nonzero cudaGetLastError().
// ---------------------------------------------------------------------------

static int grid_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  const long long cap = 132LL * 32;           // enough blocks to fill 132 SMs
  if (b > cap) b = cap;
  return b < 1 ? 1 : (int)b;
}

static int launch(bool sorted, const float* vals, const int* segs,
                  const unsigned char* valid, float* out, u64* idxw,
                  ColFlags flags, long long n, int ncols, int nrows,
                  long long nseg, cudaStream_t stream) {
  const int threads = 256;
  long long total = (long long)ncols * nrows * nseg;
  fill_kernel<<<grid_for(total, threads), threads, 0, stream>>>(
      out, idxw, ncols, nrows, nseg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    if (sorted) {
      long long warps = (n + WARP_ROWS - 1) / WARP_ROWS;
      long long blocks = (warps * 32 + threads - 1) / threads;
      dim3 grid((unsigned)blocks, ncols);
      sorted_kernel<<<grid, threads, 0, stream>>>(
          vals, segs, valid, out, idxw, flags, n, ncols, nrows, nseg);
    } else {
      dim3 grid(grid_for(n, threads), ncols);
      unsorted_kernel<<<grid, threads, 0, stream>>>(
          vals, segs, valid, out, idxw, flags, n, ncols, nrows, nseg);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  finalize_kernel<<<grid_for(total, threads), threads, 0, stream>>>(
      out, idxw, flags, ncols, nrows, nseg);
  return (int)cudaGetLastError();
}

extern "C" int segagg_unsorted(const float* vals, const int* segs,
                               const unsigned char* valid, float* out,
                               u64* idxw, ColFlags flags, long long n,
                               int ncols, int nrows, long long nseg,
                               void* stream) {
  return launch(false, vals, segs, valid, out, idxw, flags, n, ncols, nrows,
                nseg, (cudaStream_t)stream);
}

extern "C" int segagg_sorted(const float* vals, const int* segs,
                             const unsigned char* valid, float* out,
                             u64* idxw, ColFlags flags, long long n,
                             int ncols, int nrows, long long nseg,
                             void* stream) {
  return launch(true, vals, segs, valid, out, idxw, flags, n, ncols, nrows,
                nseg, (cudaStream_t)stream);
}
