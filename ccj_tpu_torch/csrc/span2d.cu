// The span's 2-D recurrences, hand-written for Hopper (sm_90a): four kernels
// over the [B, n2, n2] triangle matrices, each one launch a span for the
// whole batch.
//
//   span_v     V(i, i+s) and Vtype: hairpin, interior loops and multiloop
//              (s_energy_matrix.cc:243-358), dangles 0, 1 and 2 as
//              compile-time variants;
//   span_wbp   WBP(i, i+s) and WPP(i, i+s) over the splits d = i + g,
//              g in [0, s - 1] (pseudo_loop.cc:134-164), the WB / WP
//              weights computed inline from WBP / WPP;
//   span_wm    WMv(i, i+s), WMp(i, i+s), then WM(i, i+s) over the splits
//              k = i + g, g in [0, s - TURN - 1] (s_energy_matrix.cc:206-241);
//   wx_tables  the four weight tables WB, WP, WBPg, WPPg of the gapped step
//              from WBP / WPP, one thread a cell.
//
// Replaces no Pallas kernel: each is the counterpart of an XLA fusion of
// the JAX fill's span body (ccj_tpu/engine/fold.py:355-376):
// nested.compute_V_span (ccj_tpu/engine/nested.py:54-152),
// gapped.compute_WBP_WPP_span (ccj_tpu/engine/gapped.py:119-160),
// nested.compute_WMv_WMp_WM_span (nested.py:155-196) and gapped._wx_tables
// (gapped.py:42-59).  The port ran them as about 340 eager PyTorch ops a
// span at dangles 2 (cuda_ops.span_v_ref, span_wbp_ref, span_wm_ref and
// wx_tables_ref are those bodies, the plain versions).
//
// Exactness.  Every sum is a plain int32 sum that wraps as PyTorch's does
// (wadd: unsigned arithmetic, no clamping); unset cells hold TRI_UNSET =
// INF + 1 and V_UNSET, and sums of up to three INFs fit.  guarded_add's
// exact `== INF` test, the getters (V: INF for i >= j; WM / WMv / WMp: INF
// for a >= b), the `< INF / 2` test before the V and WBP / WPP writes, the
// first minimum among H, I and M for Vtype (argmin: rank + 1, 0 where the
// cell is not set) and dangles 1's WMp(k - 1, j - 1) quirk are kept as the
// plain versions have them.  Every minimum starts at INF, as the plain
// versions' masked reductions include INF.
//
// Bound: bytes, and by arithmetic far below a launch: at n = 100, span 37
// the three recurrences read about 0.3 MB (each live row's 496 interior
// terms of EINT and V, its multiloop and WM splits, its WBP / WPP splits),
// 0.1 us at 3.35 TB/s; wx_tables reads two and writes four [B, n2, n2]
// tables (0.24 MB at n = 100).  So these kernels are launch- and host-bound
// by nature: the design keeps each to one launch a span for the whole
// batch, no temporaries, and every read of a cell below span s (so the
// reads go through the read-only cache, and a row's one write races with
// no read).  Every operand is addressed through its own strides (the
// fills' tables come from numpy, some column-major), so the wrapper
// copies nothing.
//
// Design.  span_v, span_wbp and span_wm: one block of 128 threads a live
// (b, i) row (grid: n - s rows x B, i = 1 + blockIdx.x), its threads
// striding over the row's terms (span_v: the admissible interior (di, dj),
// di, dj >= 1, di + dj <= min(MAXLOOP + 2, s - TURN - 1), at most 496, then
// the multiloop splits g in [1, s - 3]), each keeping its minima in
// registers; warp shuffles and one shared-memory pass reduce them, and
// thread 0 writes the row's cell.  A row reads only cells of spans below s
// (and V / P of span s, written by an earlier launch), so the rows of a
// span are independent.  wx_tables: one thread a cell of the batch, the
// four outputs one [4, B, n2, n2] tensor.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kINF = 10000000;
constexpr int kHalfINF = kINF / 2;
constexpr int kVUnset = 10000;
constexpr int kTURN = 3;
constexpr int kMAXLOOP = 30;
constexpr int kE = kMAXLOOP + 2;        // EINT's di, dj extent
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWxThreads = 256;

// operand slots: cuda_ops.SPAN2D_OPERANDS, in order
enum Op {
  kV, kVtype, kWM, kWMv, kWMp, kP2, kWBP, kWPP, kH, kEINT,
  kML0, kML2, kMLip1, kMLjm1, kMLboth, kMB0, kMB2, kMB5, kMB3, kMB53, kOut, kOps
};
enum Kind { kSpanV, kSpanWBP, kSpanWM, kWx, kKinds };

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py (Span2dTable):
// the 64-bit fields first, so the wrapper packs it with one struct format.
// Every operand is read (and written) through its own strides, as the
// wrapper finds them: the fills' tables may be column-major.
struct Span2dTable {
  void* p[kOps];              // [B, n2, n2] (EINT [B, 32, 32, n2, n2]; out
                              // [4, B, n2, n2] contiguous); unused slots null
  long long bs[kOps];         // batch strides, in elements (out: none)
  long long rs[kOps];         // row (a) strides
  long long cs[kOps];         // column (b) strides
  long long edi, edj;         // EINT's di and dj strides
  int kind, B, n, n2, s, dangles;
  int MLbase, PSM, PSP, PUP, PPS, pkb, bp, cp;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// guarded_add: en = base; if (en != INF) en += add
__device__ __forceinline__ int gadd(int base, int add) {
  return base == kINF ? kINF : wadd(base, add);
}

// One batch element's [n2, n2] matrix of an operand slot, read through
// its strides (every cell read lies below span s, or in an array the
// launch does not write, so the read-only cache serves it).
struct Mat {
  const int* p;
  long long rs, cs;
  __device__ __forceinline__ int operator()(int a, int b) const {
    return __ldg(p + a * rs + b * cs);
  }
  // get_energy_WM / WMv / WMp: INF for a >= b
  __device__ __forceinline__ int get(int a, int b) const {
    return a >= b ? kINF : (*this)(a, b);
  }
};

__device__ __forceinline__ Mat mat(const Span2dTable& t, int op, int b) {
  return {static_cast<const int*>(t.p[op]) + b * t.bs[op], t.rs[op], t.cs[op]};
}

template <typename T>
__device__ __forceinline__ T* cell(const Span2dTable& t, int op, int b, int a, int c) {
  return static_cast<T*>(t.p[op]) + b * t.bs[op] + a * t.rs[op] + c * t.cs[op];
}

// The block's minimum of each v[k], in thread 0's v.
template <int K>
__device__ __forceinline__ void block_min(int (&v)[K]) {
  __shared__ int part[K][kWarps];
  const int w = (int)threadIdx.x >> 5, lane = (int)threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] = min(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
    if (lane == 0) part[k][w] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      for (int q = 1; q < kWarps; ++q) v[k] = min(v[k], part[k][q]);
  }
}

// ---------------------------------------------------------------------------
// span_v
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) span_v_kernel(const __grid_constant__ Span2dTable t) {
  const int b = (int)blockIdx.y, i = 1 + (int)blockIdx.x, s = t.s, j = i + s;
  const Mat V = mat(t, kV, b);
  int red[2] = {kINF, kINF};          // interior, multiloop

  // interior loops: k = i + di, l = j - dj (s_energy_matrix.cc:287-299)
  const int L = min(kE, s - kTURN - 1);
  if (L >= 2) {
    const Mat E = mat(t, kEINT, b);
    const int* e0 = E.p + i * E.rs + j * E.cs;
    const int side = L - 1;
    for (int q = (int)threadIdx.x; q < side * side; q += kThreads) {
      const int di = 1 + q / side, dj = 1 + q - (di - 1) * side;
      if (di + dj <= L)
        red[0] = min(red[0], wadd(__ldg(e0 + di * t.edi + dj * t.edj), V(i + di, j - dj)));
    }
  }

  // multiloop (compute_energy_VM, s_energy_matrix.cc:243-268): c = i + g
  if (s >= 4) {
    const Mat WM = mat(t, kWM, b), WMv = mat(t, kWMv, b), WMp = mat(t, kWMp, b);
    const int ML = t.MLbase, jm1 = j - 1, jm2 = j - 2;
    const int mb = mat(t, D == 2 ? kMB2 : kMB0, b)(i, j);
    int mb5 = 0, mb3 = 0, mb53 = 0;
    if (D == 1) {
      mb5 = mat(t, kMB5, b)(i, j);
      mb3 = mat(t, kMB3, b)(i, j);
      mb53 = mat(t, kMB53, b)(i, j);
    }
    for (int g = 1 + (int)threadIdx.x; g <= s - 3; g += kThreads) {
      const int c = i + g, gm1 = (g - 1) * ML;
      const int w1 = WM.get(i + 1, c - 1);
      const int p1 = WMp.get(c, jm1);
      int e = gadd(min(min(wadd(w1, WMv.get(c, jm1)), wadd(w1, p1)), wadd(gm1, p1)), mb);
      if (D == 1) {
        const int gm2 = (g - 2) * ML;
        const int w2 = WM.get(i + 2, c - 1);
        // quirk kept: WMp(k - 1, j - 1) (s_energy_matrix.cc:254)
        e = min(e, gadd(min(min(wadd(w2, WMv.get(c, jm1)), wadd(w2, WMp.get(c - 1, jm1))),
                            wadd(gm2, p1)), mb5));
        const int v2 = WMv.get(c, jm2), p2 = WMp.get(c, jm2);
        e = min(e, gadd(min(min(wadd(w1, v2), wadd(w1, p2)), wadd(gm1, p2)), mb3));
        e = min(e, gadd(min(min(wadd(w2, v2), wadd(w2, p2)), wadd(gm2, p2)), mb53));
      }
      red[1] = min(red[1], e);
    }
  }

  block_min(red);
  if (threadIdx.x == 0) {
    // compute_energy's min_rank: the first minimum of (H, I, M) wins
    int vmin = mat(t, kH, b)(i, j), rank = 0;
    if (red[0] < vmin) { vmin = red[0]; rank = 1; }
    if (red[1] < vmin) { vmin = red[1]; rank = 2; }
    const bool set = vmin < kHalfINF;
    *cell<int>(t, kV, b, i, j) = set ? vmin : kVUnset;
    *cell<signed char>(t, kVtype, b, i, j) = (signed char)(set ? rank + 1 : 0);
  }
}

// ---------------------------------------------------------------------------
// span_wbp
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) span_wbp_kernel(const __grid_constant__ Span2dTable t) {
  const int b = (int)blockIdx.y, i = 1 + (int)blockIdx.x, s = t.s, l = i + s;
  const Mat V = mat(t, kV, b), P2 = mat(t, kP2, b);
  const Mat WBP = mat(t, kWBP, b), WPP = mat(t, kWPP, b);   // row i: spans below s only
  int red[2] = {kINF, kINF};          // WBP, WPP
  for (int g = (int)threadIdx.x; g < s; g += kThreads) {
    const int d = i + g;
    const int vdl = V(d, l), pdl = P2(d, l);
    // get_WB / get_WP (i, d - 1): INF off [1, n] (i = 1, g = 0), 0 for
    // i > d - 1 (g = 0), else min(unit * g, raw)
    int wb = kINF, wp = kINF;
    if (d - 1 >= 1) {
      wb = wp = 0;
      if (g > 0) {
        wb = min(t.cp * g, WBP(i, d - 1));
        wp = min(t.PUP * g, WPP(i, d - 1));
      }
    }
    red[0] = min(red[0], min(wadd(wadd(wadd(wb, vdl), t.bp), t.PPS),
                             wadd(wadd(wadd(wb, pdl), t.PSM), t.PPS)));
    red[1] = min(red[1], min(wadd(wadd(wp, vdl), t.PPS),
                             wadd(wadd(wadd(wp, pdl), t.PSP), t.PPS)));
  }
  block_min(red);
  if (threadIdx.x == 0) {
    const int wbp = min(red[0], wadd(s >= 1 ? WBP(i, l - 1) : kINF, t.cp));
    const int wpp = min(red[1], wadd(s >= 1 ? WPP(i, l - 1) : kINF, t.PUP));
    if (wbp < kHalfINF) *cell<int>(t, kWBP, b, i, l) = wbp;
    if (wpp < kHalfINF) *cell<int>(t, kWPP, b, i, l) = wpp;
  }
}

// ---------------------------------------------------------------------------
// span_wm
// ---------------------------------------------------------------------------

// E_MLStem(V(k,j), V(k+1,j), V(k,j-1), V(k+1,j-1)) (s_energy_matrix.cc:54-112)
template <int D>
__device__ __forceinline__ int mlstem(const Span2dTable& t, const Mat& V, int b, int k, int j) {
  int e = gadd(V.get(k, j), mat(t, D == 2 ? kML2 : kML0, b)(k, j));
  if (D == 1) {
    const int ML = t.MLbase;
    const int v1 = j - k - 1 > kTURN ? V.get(k + 1, j) : kINF;
    e = min(e, gadd(v1, wadd(ML, mat(t, kMLip1, b)(k, j))));
    const int v2 = j - 1 - k > kTURN ? V.get(k, j - 1) : kINF;
    e = min(e, gadd(v2, wadd(ML, mat(t, kMLjm1, b)(k, j))));
    const int v3 = j - k - 2 > kTURN ? V.get(k + 1, j - 1) : kINF;
    e = min(e, gadd(v3, wadd(2 * ML, mat(t, kMLboth, b)(k, j))));
  }
  return e;
}

template <int D>
__global__ void __launch_bounds__(kThreads) span_wm_kernel(const __grid_constant__ Span2dTable t) {
  const int b = (int)blockIdx.y, i = 1 + (int)blockIdx.x, s = t.s, j = i + s;
  const Mat V = mat(t, kV, b), P2 = mat(t, kP2, b);
  const Mat WM = mat(t, kWM, b);      // row i: spans below s only
  const int ML = t.MLbase, psmb = t.PSM + t.pkb;
  int red[1] = {kINF};
  // compute_energy_WM: k = i + g, g in [0, s - TURN - 1]
  for (int g = (int)threadIdx.x; g <= s - kTURN - 1; g += kThreads) {
    const int k = i + g, gml = g * ML;
    const int st = mlstem<D>(t, V, b, k, j);
    const int wmb = wadd(P2(k, j), psmb);
    const int wik = i >= k - 1 ? kINF : WM(i, k - 1);
    red[0] = min(red[0], min(min(wadd(gml, st), wadd(gml, wmb)),
                             min(wadd(wik, st), wadd(wik, wmb))));
  }
  block_min(red);
  if (threadIdx.x == 0) {
    int* wmv = cell<int>(t, kWMv, b, i, j);
    int* wmp = cell<int>(t, kWMp, b, i, j);
    *wmv = min(mlstem<D>(t, V, b, i, j), wadd(mat(t, kWMv, b)(i, j - 1), ML));
    // the WMB argument is P.get(i, j), i <= j: the raw cell (W_final.cc:64)
    *wmp = min(wadd(P2(i, j), psmb), wadd(mat(t, kWMp, b)(i, j - 1), ML));
    *cell<int>(t, kWM, b, i, j) = min(red[0], wadd(WM(i, j - 1), ML));
  }
}

// ---------------------------------------------------------------------------
// wx_tables
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kWxThreads) wx_kernel(const __grid_constant__ Span2dTable t) {
  const int n2 = t.n2, n = t.n;
  const long long nn = (long long)n2 * n2, total = t.B * nn;
  const long long x = (long long)blockIdx.x * kWxThreads + threadIdx.x;
  if (x >= total) return;
  const int b = (int)(x / nn), r = (int)(x - b * nn);
  const int a = r / n2, c = r - a * n2;
  const int rb = mat(t, kWBP, b)(a, c), rp = mat(t, kWPP, b)(a, c);
  const bool inb = a >= 1 && c >= 1 && a <= n && c <= n;
  int* o = static_cast<int*>(t.p[kOut]) + x;     // [4, B, n2, n2], contiguous
  // get_WB / get_WP: INF off [1, n], 0 for a > c, else min(unit * (c - a + 1), raw)
  o[0] = !inb ? kINF : a > c ? 0 : min(t.cp * (c - a + 1), rb);
  o[total] = !inb ? kINF : a > c ? 0 : min(t.PUP * (c - a + 1), rp);
  // TriangleMatrix::get: INF for a > c
  o[2 * total] = a > c ? kINF : rb;
  o[3 * total] = a > c ? kINF : rp;
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_span2d_table_bytes() { return (int)sizeof(Span2dTable); }

// (operand slots, EINT's di / dj extent, kinds): checked against cuda_ops'
// constants at load.
extern "C" void ccj_span2d_limits(int* out) {
  out[0] = kOps;
  out[1] = kE;
  out[2] = kKinds;
}

// One launch of `table`'s kind (0 span_v, 1 span_wbp, 2 span_wm, 3
// wx_tables) on `stream`.  Returns cudaGetLastError() after the launch: 0
// on success.
extern "C" int ccj_span2d(const void* table, void* stream) {
  const Span2dTable* t = static_cast<const Span2dTable*>(table);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t->B < 1 || t->B > 65535 || t->n < 1 || t->n2 != t->n + 2 || t->s < 0 ||
      t->dangles < 0 || t->dangles > 2 || t->kind < 0 || t->kind >= kKinds)
    return (int)cudaErrorInvalidValue;
  if (t->kind == kWx) {
    const long long total = (long long)t->B * t->n2 * t->n2;
    wx_kernel<<<(unsigned)((total + kWxThreads - 1) / kWxThreads), kWxThreads, 0, st>>>(*t);
    return (int)cudaGetLastError();
  }
  const int rows = t->n - t->s;        // live rows i = 1 .. n - s
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)rows, (unsigned)t->B);
  if (t->kind == kSpanWBP) {
    span_wbp_kernel<<<grid, kThreads, 0, st>>>(*t);
  } else if (t->kind == kSpanV) {
    if (t->dangles == 0) span_v_kernel<0><<<grid, kThreads, 0, st>>>(*t);
    else if (t->dangles == 1) span_v_kernel<1><<<grid, kThreads, 0, st>>>(*t);
    else span_v_kernel<2><<<grid, kThreads, 0, st>>>(*t);
  } else {
    if (t->dangles == 0) span_wm_kernel<0><<<grid, kThreads, 0, st>>>(*t);
    else if (t->dangles == 1) span_wm_kernel<1><<<grid, kThreads, 0, st>>>(*t);
    else span_wm_kernel<2><<<grid, kThreads, 0, st>>>(*t);
  }
  return (int)cudaGetLastError();
}
