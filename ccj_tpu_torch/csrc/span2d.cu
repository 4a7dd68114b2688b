// The span's 2-D recurrences, hand-written for Hopper (sm_90a): four kernels
// over the [B, n2, n2] triangle matrices, each one launch a span for the
// whole batch.
//
//   span_v     V(i, i+s) and Vtype: hairpin, interior loops and multiloop
//              (s_energy_matrix.cc:243-358), dangles 0, 1 and 2 as
//              compile-time variants;
//   span_wbp   P's span-s diagonal from the P split's minima (when given),
//              then WBP(i, i+s) and WPP(i, i+s) over the splits d = i + g,
//              g in [0, s - 1] (pseudo_loop.cc:134-179), the WB / WP
//              weights computed inline from WBP / WPP, and (when given) the
//              span-s diagonal of the fill's kept weight tables;
//   span_wm    WMv(i, i+s), WMp(i, i+s), then WM(i, i+s) over the splits
//              k = i + g, g in [0, s - TURN - 1] (s_energy_matrix.cc:206-241);
//   wx_tables  the four weight tables WB, WP, WBPg, WPPg of the gapped step
//              from WBP / WPP, one thread a cell: once a fill.
//
// Replaces no Pallas kernel: each is the counterpart of an XLA fusion of
// the JAX fill's span body (ccj_tpu/engine/fold.py:355-376):
// nested.compute_V_span (ccj_tpu/engine/nested.py:54-152),
// gapped.compute_WBP_WPP_span (ccj_tpu/engine/gapped.py:119-160) with
// gapped._set_P_diag (:108-118), nested.compute_WMv_WMp_WM_span
// (nested.py:155-196) and gapped._wx_tables (gapped.py:42-59).  The port ran
// them as about 340 eager PyTorch ops a span at dangles 2
// (cuda_ops.span_v_ref, span_wbp_ref, span_wm_ref and wx_tables_ref are
// those bodies, the plain versions).
//
// Exactness.  Every sum is a plain int32 sum that wraps as PyTorch's does
// (wadd: unsigned arithmetic, no clamping); unset cells hold TRI_UNSET =
// INF + 1 and V_UNSET, and sums of up to three INFs fit.  guarded_add's
// exact `== INF` test, the getters (V: INF for i >= j; WM / WMv / WMp: INF
// for a >= b), the `< INF / 2` test before the V, P and WBP / WPP writes,
// the first minimum among H, I and M for Vtype (argmin: rank + 1, 0 where
// the cell is not set) and dangles 1's WMp(k - 1, j - 1) quirk are kept as
// the plain versions have them.  Every minimum starts at INF, as the plain
// versions' masked reductions include INF.
//
// Bound: bytes, and by arithmetic far below a launch: at n = 100, span 37
// the three recurrences read about 0.3 MB (each live row's 496 interior
// terms of EINT and V, its multiloop and WM splits, its WBP / WPP splits),
// 0.1 us at 3.35 TB/s; wx_tables reads two and writes four [B, n2, n2]
// tables (0.24 MB at n = 100).  So these kernels are launch- and
// latency-bound by nature: the design keeps each to one launch a span for
// the whole batch, no temporaries, and every read of a cell below span s
// (so the reads go through the read-only cache, and a row's writes race
// with no read).  Every operand is addressed through its own strides (the
// fills' tables come from numpy, some column-major), so the wrapper copies
// nothing.
//
// span_wm and wx_tables, redesigned.  Their first versions lost time the
// way span_v's did (below): span_wm's thread 0 loaded its row's own cells
// (WMv / WMp / WM(i, j - 1), P2(i, j) and E_MLStem(i, j)'s V and ML cells)
// only after the block's reduction, its split loop had a run-time trip
// count with each split's 4-10 loads behind mlstem's branches, its offsets
// were 64-bit, and it waited in the stream for the whole of span_store,
// which writes none of its operands.  The new kernels compute the same
// functions:
//   - span_wm issues every load of the row's own cells at the start
//     (thread 0), then walks the splits g in [0, s - 4] in rounds of
//     kWMTerms a thread (128 threads: one round for every s - 3 <= 256,
//     n <= 260), every load of a round (V, ML and P2 at (k, j), WM(i, k - 1);
//     dangles 1 also V(k + 1, j), V(k, j - 1), V(k + 1, j - 1) and their ML
//     tables, each only where E_MLStem takes it) before its first min;
//     32-bit offsets inside a batch element (Mat32; the wrapper checks);
//   - span_wm may be a programmatic dependent launch (the table's
//     `dependent`): it issues all its loads and reduces before
//     griddepcontrol.wait, and writes its three cells after it.  The
//     condition that makes this exact: the kernel before it in the stream
//     writes none of V, P2, WM, WMv, WMp or the ML tables.  span_store,
//     the last kernel of every fill's gapped step (fold._run_spans), writes
//     only its destination views: the 22 families' slots, the C skews'
//     rows, PKD and PKE (gapped4.dense_dests, gapped5.packed_dests,
//     gapped4.pk_dests), and it launches at every span with a live row (its
//     PKD destination is never empty); its griddepcontrol.launch_dependents
//     at its start lets span_wm's blocks start once every span_store block
//     has.  The row-sharded fills launch span_wm plainly: a transport copy
//     of a staging slab may come after the last span_store there;
//   - a warp a row with four rows a block, timed against the block a row
//     at phase 2g's shapes on an H100 (NVIDIA H100 80GB HBM3, 700 W), was
//     0.15-0.34 us faster at 100 x 4, within +-0.13 us at s <= 65 and
//     0.55-0.60 us slower at n=200 span 135: not taken (PERF.md);
//   - wx_tables takes one cell a thread and reads contiguous WBP / WPP at
//     the cell's flat offset (wx_kernel<true>: no stride arithmetic), other
//     operands (column-major tables from numpy, strided views) through
//     their strides.  Two and four consecutive cells a thread, as 8- and
//     16-byte vectors, were slower at every phase-2g shape on the same card
//     (four cells 2.42-2.59 us against one cell's 1.52-1.84, PERF.md): at
//     this size the kernel's time is a thread's own latency, not its bytes.
//
// span_v and span_wbp, redesigned.  At 2-6 us a call their first versions
// took two to three launch floors (wx_tables, one load and four
// stores a thread, takes about 2 us), so most of their time was the
// latency chain inside a block:
//   (a) span_v walked the whole (L - 1)^2 square of (di, dj) (961 q at
//       L = 32 for 496 admissible terms), an integer division a q;
//   (b) its trip count was known only at run time, so the loop was not
//       unrolled and one iteration's loads (EINT a sector a term, n2^2 * 4 B
//       apart, and V) could wait for the last one's mins;
//   (c) thread 0 loaded H(i, j) (span_v) and WBP / WPP(i, l - 1) (span_wbp)
//       only after the block's reduction: one more round trip.
// The new kernels compute the same functions:
//   - span_v walks only the admissible triangle: q in [0, L(L-1)/2) maps to
//     (di, dj) in closed form (interior_term: di-major, so a warp's V reads
//     run along a row and a cell-major EINT would be read contiguously),
//     each of the 128 threads at most kVTerms = 4 of the 496 terms, all
//     their EINT and V loads issued before the first min; the multiloop splits the same
//     way, kMTerms a round;
//   - every load of a fill-constant table (H, MB*) and of the row's own
//     earlier cells (WBP / WPP(i, l - 1), span_wbp's span-s cells) is
//     issued at the start, before the walk;
//   - offsets inside a batch element are 32-bit (the wrapper checks that
//     every operand's extent allows it); the batch offset stays 64-bit;
//   - span_wbp writes P's span-s diagonal itself: block i sets
//     P2(i, i+s) = p_min < INF / 2 ? p_min : old, the rule of
//     gapped._set_P_diag, and takes that value for its own g = 0 term.  It
//     is the launch's only read of a span-s P cell: the other blocks read
//     P2(d, l) with d > i, spans below s.  So the 11 eager ops a span of
//     _set_P_diag are gone.
//   - The fill keeps the gapped step's weight tables (WB, WP, WBPg, WPPg,
//     one [4, B, n2, n2] tensor) for the whole fill instead of rebuilding
//     them each span (one wx_tables launch a fill, and one when fill4
//     resumes).  This is exact: each table cell is elementwise in WBP /
//     WPP at the same cell, and only span_wbp writes WBP / WPP, at the
//     span-s cells (i, i + s) of rows [1, n - s]; so after span s only the
//     tables' span-s diagonal of those rows can change, and span_wbp's
//     thread 0 writes it from the value the cell now holds (its new value
//     or, where the `< INF / 2` test kept the old one, the old): WB =
//     min(cp (s + 1), WBP), WP = min(PUP (s + 1), WPP), WBPg / WPPg the raw
//     cells (those rows lie in [1, n] and a <= c).  Rows outside [1, n - s]
//     and the lower triangle never change.
// Three options were timed (ccj_tpu_torch/span2d_variants.py; the figures
// are in PERF.md):
//   - a cell-major copy of EINT ([B, n2, n2, 32, 32] in memory, made once a
//     fill: nested.cell_major_eint), so a cell's 496 terms lie in 4 KB.
//     The kernel takes it unchanged through EINT's strides.  It is as fast
//     L2-hot and faster L2-cold, as the fill finds EINT: kept;
//   - Hopper's programmatic dependent launch: where the caller says so
//     (the table's `dependent`, set by the span loops of fold._run_spans
//     and dist.wavefront._fill_sharded from their second span on) span_v
//     is launched with cudaLaunchAttributeProgrammaticStreamSerialization,
//     so it may start while the kernel before it in the stream (span_wm
//     of the last span, which calls griddepcontrol.launch_dependents at
//     its start) still runs.  The condition that makes this exact: before
//     griddepcontrol.wait span_v reads only EINT, H and MB*, and the
//     kernel before it writes none of them.  In a span loop that holds:
//     those tables are made before the loop and nothing writes them in
//     it.  A caller that cannot promise it (a kernel that writes EINT or
//     H, such as nested.cell_major_eint's copy, right before span_v)
//     launches plainly, the wrapper's default; then the wait is a no-op
//     and the stream orders every read.  V, WM, WMv, WMp and every write
//     come after the wait.  A span_wm -> span_v pair back to back is
//     faster with it: kept;
//   - 256 threads a block (two interior terms a thread): 4-10 % faster
//     L2-hot at phase 2g's shapes, mixed L2-cold (PERF.md): not
//     taken; span_v has 128 threads like span_wbp and span_wm.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kINF = 10000000;
constexpr int kHalfINF = kINF / 2;
constexpr int kVUnset = 10000;
constexpr int kTURN = 3;
constexpr int kMAXLOOP = 30;
constexpr int kE = kMAXLOOP + 2;        // EINT's di, dj extent
constexpr int kThreads = 128;        // span_v, span_wbp, span_wm
constexpr int kWxThreads = 256;
constexpr int kVTerms = (kE * (kE - 1) / 2 + kThreads - 1) / kThreads;   // 4
constexpr int kMTerms = 2;           // span_v's multiloop splits a round
constexpr int kWTerms = 2;           // span_wbp's splits a round
constexpr int kWMTerms = 2;          // span_wm's splits a thread and round

// operand slots: cuda_ops.SPAN2D_OPERANDS, in order
enum Op {
  kV, kVtype, kWM, kWMv, kWMp, kP2, kWBP, kWPP, kH, kEINT,
  kML0, kML2, kMLip1, kMLjm1, kMLboth, kMB0, kMB2, kMB5, kMB3, kMB53, kPmin, kOut, kOps
};
enum Kind { kSpanV, kSpanWBP, kSpanWM, kWx, kKinds };

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py (Span2dTable):
// the 64-bit fields first, so the wrapper packs it with one struct format.
// Every operand is read (and written) through its own strides, as the
// wrapper finds them: the fills' tables may be column-major.
struct Span2dTable {
  void* p[kOps];              // [B, n2, n2] (EINT [B, 32, 32, n2, n2]; p_min
                              // [B, n2]: column strides only; out [4, B, n2,
                              // n2] contiguous); unused slots null
  long long bs[kOps];         // batch strides, in elements (out: none)
  long long rs[kOps];         // row (a) strides
  long long cs[kOps];         // column (b) strides
  long long edi, edj;         // EINT's di and dj strides
  int kind, B, n, n2, s, dangles;
  int dependent;              // span_v, span_wm: a programmatic dependent launch
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

// The same with 32-bit strides (span_v, span_wbp): the wrapper checks that
// every operand's offsets inside one batch element fit in 31 bits.
struct Mat32 {
  const int* p;
  int rs, cs;
  __device__ __forceinline__ int operator()(int a, int b) const {
    return __ldg(p + (a * rs + b * cs));
  }
  __device__ __forceinline__ int get(int a, int b) const {
    return a >= b ? kINF : (*this)(a, b);
  }
};

__device__ __forceinline__ Mat32 mat32(const Span2dTable& t, int op, int b) {
  return {static_cast<const int*>(t.p[op]) + b * t.bs[op], (int)t.rs[op], (int)t.cs[op]};
}

// One cell of the [4, B, n2, n2] out slot (contiguous).
__device__ __forceinline__ int* out_cell(const Span2dTable& t, int k, int b, int a, int c) {
  return static_cast<int*>(t.p[kOut]) + ((long long)(k * t.B + b) * t.n2 + a) * t.n2 + c;
}

template <typename T>
__device__ __forceinline__ T* cell(const Span2dTable& t, int op, int b, int a, int c) {
  return static_cast<T*>(t.p[op]) + b * t.bs[op] + a * t.rs[op] + c * t.cs[op];
}

// The block's minimum of each v[k], in thread 0's v.
template <int K>
__device__ __forceinline__ void block_min(int (&v)[K]) {
  constexpr int kWarps = kThreads / 32;
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

// Programmatic dependent launch: a kernel launched with the attribute
// waits here until the kernel before it has finished and its writes are
// visible; its reads before the wait touch only tables that kernel does
// not write.  Without the attribute both are no-ops.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" :::);
}

// ---------------------------------------------------------------------------
// span_v
// ---------------------------------------------------------------------------

// The admissible interior term q in [0, L(L-1)/2) of a row whose loops
// reach di + dj <= L (di, dj >= 1): di-major, di = 1 first (L - 1 terms)
// down to di = L - 1 (one term), dj rising within a di.  p = nq - 1 - q
// counts from the last term, whose di row is the k-th from the end with
// k(k+1)/2 <= p < (k+1)(k+2)/2; 8p + 1 <= 3961, so sqrtf is exact enough
// for the floor (the nearest boundary, a perfect square, lies 1/126 away).
__device__ __forceinline__ void interior_term(int q, int L, int nq, int& di, int& dj) {
  const int p = nq - 1 - q;
  const int k = (int)((sqrtf(8.0f * (float)p + 1.0f) - 1.0f) * 0.5f);
  di = L - 1 - k;
  dj = 1 + k - (p - k * (k + 1) / 2);
}

// One multiloop split's loads (compute_energy_VM, s_energy_matrix.cc:243-268)
// at c = i + g: WM(i + 1, c - 1), WMv / WMp(c, j - 1); dangles 1 also
// WM(i + 2, c - 1), WMp(c - 1, j - 1) (the quirk kept,
// s_energy_matrix.cc:254), WMv / WMp(c, j - 2).
struct MLTerm {
  int w1, v1, p1, w2, pq, v2, p2;
};

template <int D>
__device__ __forceinline__ MLTerm ml_load(const Mat32& WM, const Mat32& WMv, const Mat32& WMp,
                                          int i, int j, int c) {
  MLTerm m;
  m.w1 = WM.get(i + 1, c - 1);
  m.v1 = WMv.get(c, j - 1);
  m.p1 = WMp.get(c, j - 1);
  m.w2 = m.pq = m.v2 = m.p2 = 0;
  if (D == 1) {
    m.w2 = WM.get(i + 2, c - 1);
    m.pq = WMp.get(c - 1, j - 1);
    m.v2 = WMv.get(c, j - 2);
    m.p2 = WMp.get(c, j - 2);
  }
  return m;
}

template <int D>
__device__ __forceinline__ int ml_term(const MLTerm& m, int g, int ML, int mb, int mb5, int mb3,
                                       int mb53) {
  const int gm1 = (g - 1) * ML;
  int e = gadd(min(min(wadd(m.w1, m.v1), wadd(m.w1, m.p1)), wadd(gm1, m.p1)), mb);
  if (D == 1) {
    const int gm2 = (g - 2) * ML;
    e = min(e, gadd(min(min(wadd(m.w2, m.v1), wadd(m.w2, m.pq)), wadd(gm2, m.p1)), mb5));
    e = min(e, gadd(min(min(wadd(m.w1, m.v2), wadd(m.w1, m.p2)), wadd(gm1, m.p2)), mb3));
    e = min(e, gadd(min(min(wadd(m.w2, m.v2), wadd(m.w2, m.p2)), wadd(gm2, m.p2)), mb53));
  }
  return e;
}

template <int D>
__global__ void __launch_bounds__(kThreads) span_v_kernel(const __grid_constant__ Span2dTable t) {
  const int b = (int)blockIdx.y, i = 1 + (int)blockIdx.x, s = t.s, j = i + s;
  const int tid = (int)threadIdx.x;

  // Fill-constant loads first: H (thread 0), the MB tables (every thread
  // with a multiloop split; one address, a broadcast).
  const bool multi = s >= 4;
  const int h = tid == 0 ? mat32(t, kH, b)(i, j) : kINF;
  int mb = 0, mb5 = 0, mb3 = 0, mb53 = 0;
  if (multi && 1 + tid <= s - 3) {
    mb = mat32(t, D == 2 ? kMB2 : kMB0, b)(i, j);
    if (D == 1) {
      mb5 = mat32(t, kMB5, b)(i, j);
      mb3 = mat32(t, kMB3, b)(i, j);
      mb53 = mat32(t, kMB53, b)(i, j);
    }
  }

  // Interior loops (s_energy_matrix.cc:287-299): k = i + di, l = j - dj,
  // the nq admissible terms, at most kVTerms a thread, EINT first.
  const int L = min(kE, s - kTURN - 1);
  const int nq = L >= 2 ? L * (L - 1) / 2 : 0;
  const int* E = static_cast<const int*>(t.p[kEINT]) + b * t.bs[kEINT] +
                 (i * (int)t.rs[kEINT] + j * (int)t.cs[kEINT]);
  const int edi = (int)t.edi, edj = (int)t.edj;
  int ev[kVTerms], off[kVTerms];
#pragma unroll
  for (int k = 0; k < kVTerms; ++k) {
    const int q = tid + k * kThreads;
    ev[k] = kINF;
    off[k] = -1;
    if (q < nq) {
      int di, dj;
      interior_term(q, L, nq, di, dj);
      ev[k] = __ldg(E + (di * edi + dj * edj));
      off[k] = (i + di) * (int)t.rs[kV] + (j - dj) * (int)t.cs[kV];
    }
  }
  grid_dependency_wait();             // V, WM, WMv, WMp: written by earlier kernels
  const Mat32 V = mat32(t, kV, b);
  int vv[kVTerms];
#pragma unroll
  for (int k = 0; k < kVTerms; ++k) vv[k] = off[k] >= 0 ? __ldg(V.p + off[k]) : 0;

  // Multiloop splits g in [1, s - 3], kMTerms a round, loads first.
  int red[2] = {kINF, kINF};          // interior, multiloop
  if (multi) {
    const Mat32 WM = mat32(t, kWM, b), WMv = mat32(t, kWMv, b), WMp = mat32(t, kWMp, b);
    for (int g0 = 1 + tid; g0 <= s - 3; g0 += kMTerms * kThreads) {
      MLTerm m[kMTerms];
#pragma unroll
      for (int k = 0; k < kMTerms; ++k) {
        const int g = g0 + k * kThreads;
        if (g <= s - 3) m[k] = ml_load<D>(WM, WMv, WMp, i, j, i + g);
      }
#pragma unroll
      for (int k = 0; k < kMTerms; ++k) {
        const int g = g0 + k * kThreads;
        if (g <= s - 3) red[1] = min(red[1], ml_term<D>(m[k], g, t.MLbase, mb, mb5, mb3, mb53));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kVTerms; ++k) red[0] = min(red[0], wadd(ev[k], vv[k]));

  block_min(red);
  if (tid == 0) {
    // compute_energy's min_rank: the first minimum of (H, I, M) wins
    int vmin = h, rank = 0;
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
  const int tid = (int)threadIdx.x;
  const Mat32 V = mat32(t, kV, b), P2 = mat32(t, kP2, b);
  const Mat32 WBP = mat32(t, kWBP, b), WPP = mat32(t, kWPP, b);

  // Thread 0's loads before the walk: the row's cells (i, l - 1), its
  // span-s cells, P's span-s cell and its P-split minimum.  Block i is the
  // launch's only reader and writer of its span-s cells.
  int wbp_prev = kINF, wpp_prev = kINF, wbp_old = 0, wpp_old = 0, p_own = 0;
  if (tid == 0) {
    if (s >= 1) {
      wbp_prev = WBP(i, l - 1);
      wpp_prev = WPP(i, l - 1);
    }
    wbp_old = WBP(i, l);
    wpp_old = WPP(i, l);
    p_own = P2(i, l);
    if (t.p[kPmin] != nullptr) {
      // gapped._set_P_diag: P(i, l) = p_min < INF / 2 ? p_min : old
      const int pm = __ldg(static_cast<const int*>(t.p[kPmin]) + b * t.bs[kPmin] +
                           i * (int)t.cs[kPmin]);
      if (pm < kHalfINF) {
        p_own = pm;
        *cell<int>(t, kP2, b, i, l) = pm;
      }
    }
  }

  // The splits d = i + g, g in [0, s - 1], kWTerms a round, loads first.
  int red[2] = {kINF, kINF};          // WBP, WPP
  for (int g0 = tid; g0 < s; g0 += kWTerms * kThreads) {
    int vdl[kWTerms], pdl[kWTerms], wb[kWTerms], wp[kWTerms];
#pragma unroll
    for (int k = 0; k < kWTerms; ++k) {
      const int g = g0 + k * kThreads, d = i + g;
      vdl[k] = pdl[k] = 0;
      wb[k] = wp[k] = kINF;
      if (g < s) {
        vdl[k] = V(d, l);
        pdl[k] = g == 0 ? p_own : P2(d, l);
        // get_WB / get_WP (i, d - 1): INF off [1, n] (i = 1, g = 0), 0 for
        // i > d - 1 (g = 0), else min(unit * g, raw): the raw cell here
        if (g > 0) {
          wb[k] = WBP(i, d - 1);
          wp[k] = WPP(i, d - 1);
        } else if (d - 1 >= 1) {
          wb[k] = wp[k] = 0;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWTerms; ++k) {
      const int g = g0 + k * kThreads;
      if (g < s) {
        const int b_ = g > 0 ? min(t.cp * g, wb[k]) : wb[k];
        const int p_ = g > 0 ? min(t.PUP * g, wp[k]) : wp[k];
        red[0] = min(red[0], min(wadd(wadd(wadd(b_, vdl[k]), t.bp), t.PPS),
                                 wadd(wadd(wadd(b_, pdl[k]), t.PSM), t.PPS)));
        red[1] = min(red[1], min(wadd(wadd(p_, vdl[k]), t.PPS),
                                 wadd(wadd(wadd(p_, pdl[k]), t.PSP), t.PPS)));
      }
    }
  }
  block_min(red);
  if (tid == 0) {
    const int wbp = min(red[0], wadd(wbp_prev, t.cp));
    const int wpp = min(red[1], wadd(wpp_prev, t.PUP));
    const int wbp_new = wbp < kHalfINF ? wbp : wbp_old;
    const int wpp_new = wpp < kHalfINF ? wpp : wpp_old;
    if (wbp < kHalfINF) *cell<int>(t, kWBP, b, i, l) = wbp;
    if (wpp < kHalfINF) *cell<int>(t, kWPP, b, i, l) = wpp;
    if (t.p[kOut] != nullptr) {
      // the kept weight tables' span-s cell (wx_tables' rule, 1 <= i <= l <= n)
      *out_cell(t, 0, b, i, l) = min(t.cp * (s + 1), wbp_new);
      *out_cell(t, 1, b, i, l) = min(t.PUP * (s + 1), wpp_new);
      *out_cell(t, 2, b, i, l) = wbp_new;
      *out_cell(t, 3, b, i, l) = wpp_new;
    }
  }
}

// ---------------------------------------------------------------------------
// span_wm
// ---------------------------------------------------------------------------

// One WM split's loads at k (compute_energy_WM, s_energy_matrix.cc:219-241):
// E_MLStem(V(k,j), V(k+1,j), V(k,j-1), V(k+1,j-1))'s V and ML cells
// (s_energy_matrix.cc:54-112; dangles 1 loads a V cell and its ML table only
// where E_MLStem takes it, the others are INF), P2(k, j) and WM(i, k - 1)
// (INF for i >= k - 1).  At k = i the same loads give the row's own
// E_MLStem(i, j) and P2(i, j) (its WM entry unused).
struct WMTerm {
  int v0, m0, v1, m1, v2, m2, v3, m3, p, w;
};

struct WMOps {
  Mat32 V, P2, WM, ML, MLip1, MLjm1, MLboth;
};

template <int D>
__device__ __forceinline__ WMOps wm_ops(const Span2dTable& t, int b) {
  WMOps o;
  o.V = mat32(t, kV, b);
  o.P2 = mat32(t, kP2, b);
  o.WM = mat32(t, kWM, b);
  o.ML = mat32(t, D == 2 ? kML2 : kML0, b);
  o.MLip1 = o.MLjm1 = o.MLboth = o.ML;
  if (D == 1) {
    o.MLip1 = mat32(t, kMLip1, b);
    o.MLjm1 = mat32(t, kMLjm1, b);
    o.MLboth = mat32(t, kMLboth, b);
  }
  return o;
}

template <int D>
__device__ __forceinline__ WMTerm wm_load(const WMOps& o, int i, int j, int k) {
  WMTerm m;
  m.v0 = o.V.get(k, j);
  m.m0 = o.ML(k, j);
  m.p = o.P2(k, j);
  m.w = i >= k - 1 ? kINF : o.WM(i, k - 1);
  m.v1 = m.v2 = m.v3 = kINF;
  m.m1 = m.m2 = m.m3 = 0;
  if (D == 1) {
    if (j - k - 1 > kTURN) {
      m.v1 = o.V(k + 1, j);
      m.m1 = o.MLip1(k, j);
    }
    if (j - 1 - k > kTURN) {
      m.v2 = o.V(k, j - 1);
      m.m2 = o.MLjm1(k, j);
    }
    if (j - k - 2 > kTURN) {
      m.v3 = o.V(k + 1, j - 1);
      m.m3 = o.MLboth(k, j);
    }
  }
  return m;
}

// E_MLStem of the loaded cells: gadd(V, ML) and, at dangles 1, the three
// one-sided and two-sided terms (an unloaded V is INF, and gadd keeps it).
template <int D>
__device__ __forceinline__ int wm_stem(const WMTerm& m, int ML) {
  int e = gadd(m.v0, m.m0);
  if (D == 1) {
    e = min(e, gadd(m.v1, wadd(ML, m.m1)));
    e = min(e, gadd(m.v2, wadd(ML, m.m2)));
    e = min(e, gadd(m.v3, wadd(2 * ML, m.m3)));
  }
  return e;
}

template <int D>
__global__ void __launch_bounds__(kThreads) span_wm_kernel(const __grid_constant__ Span2dTable t) {
  const int b = (int)blockIdx.y, s = t.s, i = 1 + (int)blockIdx.x, j = i + s;
  const int ML = t.MLbase, psmb = t.PSM + t.pkb;
  launch_dependents();                // the next span's span_v may start
  const WMOps o = wm_ops<D>(t, b);

  // The row's own cells first (thread 0): E_MLStem(i, j) and P2(i, j), and
  // WMv / WMp / WM(i, j - 1).  Row i's cells below span s only: no block
  // of this launch writes them.
  WMTerm own{};
  int wmv_prev = 0, wmp_prev = 0, wm_prev = 0;
  if (threadIdx.x == 0) {
    own = wm_load<D>(o, i, j, i);
    wmv_prev = mat32(t, kWMv, b)(i, j - 1);
    wmp_prev = mat32(t, kWMp, b)(i, j - 1);
    wm_prev = o.WM(i, j - 1);
  }

  // compute_energy_WM: k = i + g, g in [0, s - TURN - 1], kWMTerms a
  // thread and round, every load of a round before its first min.
  int red[1] = {kINF};
  for (int g0 = (int)threadIdx.x; g0 <= s - kTURN - 1; g0 += kWMTerms * kThreads) {
    WMTerm m[kWMTerms];
#pragma unroll
    for (int q = 0; q < kWMTerms; ++q) {
      const int g = g0 + q * kThreads;
      if (g <= s - kTURN - 1) m[q] = wm_load<D>(o, i, j, i + g);
    }
#pragma unroll
    for (int q = 0; q < kWMTerms; ++q) {
      const int g = g0 + q * kThreads;
      if (g <= s - kTURN - 1) {
        const int gml = g * ML, st = wm_stem<D>(m[q], ML), wmb = wadd(m[q].p, psmb);
        red[0] = min(red[0], min(min(wadd(gml, st), wadd(gml, wmb)),
                                 min(wadd(m[q].w, st), wadd(m[q].w, wmb))));
      }
    }
  }
  block_min(red);
  grid_dependency_wait();             // the writes after the kernel before this one's
  if (threadIdx.x == 0) {
    *cell<int>(t, kWMv, b, i, j) = min(wm_stem<D>(own, ML), wadd(wmv_prev, ML));
    // the WMB argument is P.get(i, j), i <= j: the raw cell (W_final.cc:64)
    *cell<int>(t, kWMp, b, i, j) = min(wadd(own.p, psmb), wadd(wmp_prev, ML));
    *cell<int>(t, kWM, b, i, j) = min(red[0], wadd(wm_prev, ML));
  }
}

// ---------------------------------------------------------------------------
// wx_tables
// ---------------------------------------------------------------------------

// get_WB / get_WP (INF off [1, n], 0 for a > c, else min(unit * (c - a + 1),
// raw)) and TriangleMatrix::get (INF for a > c) of one cell
struct WxCell {
  int wb, wp, wbpg, wppg;
};

__device__ __forceinline__ WxCell wx_cell(const Span2dTable& t, int a, int c, int rb, int rp) {
  const bool inb = a >= 1 && c >= 1 && a <= t.n && c <= t.n;
  WxCell w;
  w.wb = !inb ? kINF : a > c ? 0 : min(t.cp * (c - a + 1), rb);
  w.wp = !inb ? kINF : a > c ? 0 : min(t.PUP * (c - a + 1), rp);
  w.wbpg = a > c ? kINF : rb;
  w.wppg = a > c ? kINF : rp;
  return w;
}

// One cell x of the flat [B, n2, n2] plane a thread; the four outputs one
// contiguous [4, B, n2, n2] tensor.  kFlat: WBP and WPP contiguous (the
// launch checks), read at x; else through the operands' strides.
template <bool kFlat>
__global__ void __launch_bounds__(kWxThreads) wx_kernel(const __grid_constant__ Span2dTable t) {
  const int n2 = t.n2;
  const long long nn = (long long)n2 * n2, total = t.B * nn;
  const long long x = (long long)blockIdx.x * kWxThreads + threadIdx.x;
  if (x >= total) return;
  const int b = (int)(x / nn), r = (int)(x - b * nn);
  const int a = r / n2, c = r - a * n2;
  int rb, rp;
  if (kFlat) {
    rb = __ldg(static_cast<const int*>(t.p[kWBP]) + x);
    rp = __ldg(static_cast<const int*>(t.p[kWPP]) + x);
  } else {
    rb = mat(t, kWBP, b)(a, c);
    rp = mat(t, kWPP, b)(a, c);
  }
  const WxCell w = wx_cell(t, a, c, rb, rp);
  int* o = static_cast<int*>(t.p[kOut]) + x;
  o[0] = w.wb;
  o[total] = w.wp;
  o[2 * total] = w.wbpg;
  o[3 * total] = w.wppg;
}

// wx_tables' flat path: WBP and WPP contiguous [B, n2, n2].
bool wx_flat(const Span2dTable& t) {
  const long long nn = (long long)t.n2 * t.n2;
  const int ops[2] = {kWBP, kWPP};
  for (const int op : ops)
    if ((t.B > 1 && t.bs[op] != nn) || t.rs[op] != t.n2 || t.cs[op] != 1) return false;
  return true;
}

// The launch of span_v or span_wm: a programmatic dependent of the kernel
// before it in the stream where the table asks for it, else plain.
template <typename Kernel>
cudaError_t launch_dependent(Kernel kernel, dim3 grid, cudaStream_t st, const Span2dTable& t) {
  if (!t.dependent) {
    kernel<<<grid, kThreads, 0, st>>>(t);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, t);
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
    const unsigned blocks = (unsigned)((total + kWxThreads - 1) / kWxThreads);
    if (wx_flat(*t)) wx_kernel<true><<<blocks, kWxThreads, 0, st>>>(*t);
    else wx_kernel<false><<<blocks, kWxThreads, 0, st>>>(*t);
    return (int)cudaGetLastError();
  }
  const int rows = t->n - t->s;        // live rows i = 1 .. n - s
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)rows, (unsigned)t->B);
  cudaError_t e = cudaSuccess;
  if (t->kind == kSpanWBP) {
    span_wbp_kernel<<<grid, kThreads, 0, st>>>(*t);
  } else if (t->kind == kSpanV) {
    e = t->dangles == 0 ? launch_dependent(span_v_kernel<0>, grid, st, *t)
        : t->dangles == 1 ? launch_dependent(span_v_kernel<1>, grid, st, *t)
                          : launch_dependent(span_v_kernel<2>, grid, st, *t);
  } else {
    e = t->dangles == 0 ? launch_dependent(span_wm_kernel<0>, grid, st, *t)
        : t->dangles == 1 ? launch_dependent(span_wm_kernel<1>, grid, st, *t)
                          : launch_dependent(span_wm_kernel<2>, grid, st, *t);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
