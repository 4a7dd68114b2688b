// history_min: every history scan of a span (the gapped step's l-shrink /
// i-shrink scans RL and RI, 16 a span) in one launch, for every batch
// element, hand-written for Hopper (sm_90a).
//
// A launch takes a list of WINDOWS.  A window is one family's history,
// read in place from the state: a list of parts (the dense layout's one
// int16 view, or one view per prior segment of the packed layout), each
// [B, TBw, U, Rw, n2] with span u at history distance d = d0 - u, a mode
// (RL 0, RI 1), a g1, and one or two output planes, each with its weight
// table X (int32 [B, n2, n2]).  For every output plane k of a window and
// every cell (b, tt, r, j) of the output [K, B, TB, R, n2] (row r is
// i = i0 + r):
//
//   out[k, b, tt, r, j] = min(INF, min over parts p, spans u of
//                             win_p[b, tt, u, r, j] + w_k(d))
//
// over the terms whose distance satisfies
//
//   RL (mode 0):  1 <= d <= (i + s) - (j + tt + 2) - g1       (l - k - g1)
//   RI (mode 1):  1 <= d <= (j - i) - g1,  and i >= 1
//
// and whose row r lies within the part's rows (r < Rw: rows past them, the
// C rows l = i + s >= n2 of RI, give no term); a part's tt rows past its
// own (tt >= TBw: the packed layout's earlier segments) read as SAT16.
// The weights are computed here from the table: RL takes X(l - d + 1, l)
// with l = i + s (column l of X), RI X(i, i + d - 1) (row i of X), INF
// where the index leaves the table (gapped4.g2).  Every output cell is
// written once, INF where it has no term: the caller allocates the output
// with torch.empty and fills nothing.  All arithmetic is int32: a window
// value is at most SAT16 and a weight at most INF = 10^7.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusions of
// the JAX package's RL / RI closures, ccj_tpu/engine/gapped4.py:306-341
// (dense) and ccj_tpu/engine/gapped5.py:313-365 (packed), 16 closures a
// span, 12 distinct windows among them (gapped4.HISTORY_SCANS).
//
// Bound: bytes.  The function reads each window element that an admissible
// term uses once (a window shared by two scans once, not twice), the X
// elements the rows' weights take, and writes 4 bytes per output cell and
// plane; its add-min terms (one DPX add-min each) are far below the int32
// rate.  What the design does about it (the first version made one launch
// a scan, one thread a cell, one 2-byte load a span chained into a min with
// a weight load from device memory, and read and wrote an INF-filled acc):
//
// * One block per (b, run of 256 x VEC output cells of the flattened
//   (r, j) plane, group of TPT tt rows).  A window's (r, j) plane at fixed
//   (tt, u) is one contiguous run of memory in every layout (the rows of a
//   family block or a C skew follow each other), so a warp's loads of
//   neighbouring cells coalesce across row ends too.  The block stages the
//   weights of its rows (two or three) in shared memory once, for every
//   d in [1, s] and every (mode, table) the launch uses: 6 (s + 1) int32 a
//   row, 4.8 KB at s = 199.  A term then costs its window load and a
//   broadcast shared-memory read shared by the thread's TPT tt rows.
// * Each window is read once and its one or two scans are served from the
//   same load (the four windows shared by two scans: 25 % fewer window
//   bytes than one launch a scan).
// * Loads: with n2 even, even strides and 4-byte aligned views (every
//   fill's layout), a thread takes two neighbouring j (VEC = 2) in one
//   4-byte load, else one (VEC = 1).  16-byte loads were not chosen: a run
//   starts at any even byte offset (the packed segments' span strides make
//   the offset change with u), so a thread's cells would move with u.
// * Bytes in flight (the first of the two options: independent loads
//   unrolled over spans).  A thread issues UNR spans of its TPT tt rows,
//   UNR x TPT loads, before it adds any, and keeps each loaded word packed
//   until its add, one register a load.  The span loop runs warp-uniform
//   from the warp's lowest admissible span (__reduce_min_sync), each cell
//   predicated on its own range, so the loads of one instruction stay one
//   contiguous run.  (VEC, TPT, UNR) is (2, 2, 8) where VEC = 2 is
//   allowed, else (1, 2, 16).  (2, 1, 16), (2, 2, 16) and (2, 4, 8),
//   tried on an H100 at chip_smoke.py's phase 2d shapes, were all slower
//   at the packed n=200 span, the largest, and none was more than an
//   eighth faster at any other (the most: (2, 1, 16) at the dense row
//   shard's small launches).  The
//   kernel is bound by its loads (history_variants.py times a build
//   without the adds and one without the loads; PERF.md has the figures).
// * Only admissible terms are loaded (per cell, u in [max(0, d0 - bound),
//   min(U, d0))); a tt row past a part's reads no memory.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxWindows = 16;         // cuda_ops.HISTORY_MAX_WINDOWS
constexpr int kMaxParts = 8;            // cuda_ops.HISTORY_MAX_PARTS
constexpr int kMaxSegs = 16;            // cuda_ops.HISTORY_MAX_SEGS
constexpr int kMaxTables = 3;           // cuda_ops.HISTORY_MAX_TABLES
constexpr int kThreads = 256;
constexpr int kSAT16 = 32767;
constexpr int kSAT16x2 = (kSAT16 << 16) | kSAT16;
constexpr int kINF = 10000000;

// The strides and extents every view of one part position shares (all the
// family blocks of one packed segment, all the C skews of one): the views
// themselves are only base pointers.  Mirrored field for field by
// ccj_tpu_torch/engine/cuda_ops.py:HistSeg.
struct HistSeg {
  long long ws[5];            // element strides of an int16 view [B, TBw, U, Rw, n2]
  int TBw, U, Rw, d0;         // tt rows, spans (cut to d0), rows; span u has d = d0 - u
};

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py:HistWin.
struct HistWin {
  int mode, g1, nparts, nout;
  int tab[2], out[2];         // (weight table, output plane) of each scan
  unsigned char seg[kMaxParts];   // each part's HistSeg
};

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py:HistTable.
struct HistTable {
  const short* win[kMaxWindows][kMaxParts];   // each window's parts
  HistSeg seg[kMaxSegs];
  HistWin w[kMaxWindows];
  const int* X[kMaxTables];   // int32 [B, n2, n2] weight tables
  long long xs[kMaxTables][3];
  int* out;                   // int32 [K, B, TB, R, n2] contiguous, every cell written
  int nwin, nseg, B, TB, R, n2, s, i0;
  int wmask;                  // bit mode * kMaxTables + table: the weights staged
};

__device__ __forceinline__ int add_min(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && (__CUDACC_VER_MAJOR__ >= 12)
  return __viaddmin_s32(a, b, c);       // min(a + b, c), one DPX instruction
#else
  return min(a + b, c);
#endif
}

// One part of one window into the thread's TPT x VEC cells (tt0 + k,
// j + v): NOUT scans with weights w0 (and w1), by distance d.
template <int VEC, int TPT, int UNR, int NOUT>
__device__ __forceinline__ void scan_part(const short* base, const HistSeg& S, int tt0,
                                          bool rowok, const int (&bnd)[TPT][VEC],
                                          const int* w0, const int* w1,
                                          int (&best0)[TPT][VEC], int (&best1)[TPT][VEC]) {
  const int uhi = S.U;                  // the wrapper cut U to d0: d >= 1
  int ulo[TPT][VEC], uany[TPT];
  int lo = uhi;
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    uany[k] = uhi;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      ulo[k][v] = rowok && bnd[k][v] >= 1 ? max(0, S.d0 - bnd[k][v]) : uhi;
      uany[k] = min(uany[k], ulo[k][v]);
    }
    lo = min(lo, uany[k]);
    if (tt0 + k >= S.TBw) uany[k] = uhi;   // tt rows past the part's: SAT16, no load
  }
  lo = __reduce_min_sync(0xffffffffu, lo);       // warp-uniform span loop
  if (lo >= uhi) return;
  const short* pk[TPT];
#pragma unroll
  for (int k = 0; k < TPT; ++k) pk[k] = base + (long long)(tt0 + k) * S.ws[1];
  const int us = (int)S.ws[2];          // the wrapper checks |U ws2| < 2^31
  for (int u = lo; u < uhi; u += UNR) {
    int x[UNR][TPT];                    // packed words (VEC = 2) or values, as loaded
#pragma unroll
    for (int a = 0; a < UNR; ++a) {
      const int uu = u + a;
#pragma unroll
      for (int k = 0; k < TPT; ++k) {
#if defined(HISTORY_SKIP_LOADS)        // timing-only build (history_variants.py)
        const bool ld = false;
#else
        const bool ld = uu < uhi && uu >= uany[k];
#endif
        if (VEC == 2)
          x[a][k] = ld ? __ldg(reinterpret_cast<const int*>(pk[k] + uu * us)) : kSAT16x2;
        else
          x[a][k] = ld ? (int)__ldg(pk[k] + uu * us) : kSAT16;
      }
    }
#pragma unroll
    for (int a = 0; a < UNR; ++a) {
      const int uu = u + a;
      if (uu >= uhi) break;
      const int d = S.d0 - uu;
      const int y0 = w0[d];
      const int y1 = NOUT > 1 ? w1[d] : 0;
#pragma unroll
      for (int k = 0; k < TPT; ++k) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          // j (low half, little-endian) and j + 1 (high half) of a word
          const int xv = VEC == 1 ? x[a][k] : (v == 0 ? (int)(short)(x[a][k] & 0xffff)
                                                      : x[a][k] >> 16);
#if defined(HISTORY_SKIP_ADDS)         // timing-only build (history_variants.py)
          best0[k][v] ^= xv;
#else
          if (uu >= ulo[k][v]) {
            best0[k][v] = add_min(xv, y0, best0[k][v]);
            if (NOUT > 1) best1[k][v] = add_min(xv, y1, best1[k][v]);
          }
#endif
        }
      }
    }
  }
}

template <int VEC, int TPT, int UNR>
__global__ void __launch_bounds__(kThreads)
history_kernel(const __grid_constant__ HistTable t) {
  extern __shared__ int wsm[];          // [rows][2][kMaxTables][s + 1]: weights by d
  const int b = blockIdx.z;
  const int tt0 = blockIdx.y * TPT;
  const int cells = t.R * t.n2;
  const int e0 = blockIdx.x * (kThreads * VEC);
  const int rlo = e0 / t.n2;
  const int rhi = min(t.R - 1, (e0 + kThreads * VEC - 1) / t.n2);
  const int D = t.s + 1;
  const int W6 = 2 * kMaxTables * D;

  for (int x = threadIdx.x; x < (rhi - rlo + 1) * W6; x += kThreads) {
    const int rr = x / W6;
    const int mt = (x - rr * W6) / D;
    const int d = x - rr * W6 - mt * D;
    const int i = t.i0 + rlo + rr;
    int v = kINF;
    if (((t.wmask >> mt) & 1) && d >= 1) {
      const int tab = mt % kMaxTables;
      int ra, cb;
      if (mt < kMaxTables) {            // RL: X(l - d + 1, l), l = i + s
        cb = i + t.s;
        ra = cb - d + 1;
      } else {                          // RI: X(i, i + d - 1)
        ra = i;
        cb = i + d - 1;
      }
      if (ra >= 0 && ra < t.n2 && cb >= 0 && cb < t.n2)
        v = __ldg(t.X[tab] + b * t.xs[tab][0] + ra * t.xs[tab][1] + cb * t.xs[tab][2]);
    }
    wsm[x] = v;
  }
  __syncthreads();

  // the thread's cells: e .. e + VEC - 1 of the (r, j) plane, one row (with
  // VEC = 2, n2 is even); cells past the plane and tt rows past TB take
  // part in the warp's loops with no term and write nothing
  const int e = e0 + threadIdx.x * VEC;
  const bool act = e < cells;
  const int r = act ? e / t.n2 : rlo;
  const int j = e - r * t.n2;
  const int i = t.i0 + r;
  const int* wrow = wsm + (r - rlo) * W6;
  const long long plane = (long long)t.TB * cells;      // a plane of one batch element
  int* outp = t.out + (long long)b * plane + e;
  for (int wi = 0; wi < t.nwin; ++wi) {
    const HistWin& W = t.w[wi];
    int bnd[TPT][VEC], best0[TPT][VEC], best1[TPT][VEC];
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int tt = tt0 + k;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int jj = j + v;
        bnd[k][v] = 0;
        if (act && tt < t.TB)
          bnd[k][v] = W.mode == 0 ? (i + t.s) - (jj + tt + 2) - W.g1
                                  : (i >= 1 ? (jj - i) - W.g1 : 0);
        best0[k][v] = best1[k][v] = kINF;
      }
    }
    const int* w0 = wrow + (W.mode * kMaxTables + W.tab[0]) * D;
    const int* w1 = wrow + (W.mode * kMaxTables + W.tab[W.nout > 1 ? 1 : 0]) * D;
    for (int p = 0; p < W.nparts; ++p) {
      const HistSeg& S = t.seg[W.seg[p]];
      const short* base = t.win[wi][p] + b * S.ws[0] + r * S.ws[3] + (long long)j * S.ws[4];
      if (W.nout > 1)
        scan_part<VEC, TPT, UNR, 2>(base, S, tt0, r < S.Rw, bnd, w0, w1, best0, best1);
      else
        scan_part<VEC, TPT, UNR, 1>(base, S, tt0, r < S.Rw, bnd, w0, w1, best0, best1);
    }
    if (!act) continue;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int tt = tt0 + k;
      if (tt >= t.TB) break;
      int* o0 = outp + W.out[0] * t.B * plane + (long long)tt * cells;
      int* o1 = outp + W.out[W.nout > 1 ? 1 : 0] * t.B * plane + (long long)tt * cells;
      if (VEC == 2) {
        *reinterpret_cast<int2*>(o0) = make_int2(best0[k][0], best0[k][VEC - 1]);
        if (W.nout > 1) *reinterpret_cast<int2*>(o1) = make_int2(best1[k][0], best1[k][VEC - 1]);
      } else {
        *o0 = best0[k][0];
        if (W.nout > 1) *o1 = best1[k][0];
      }
    }
  }
}

template <int VEC, int TPT, int UNR>
int launch(const HistTable& t, cudaStream_t stream) {
  const int rows = (kThreads * VEC + t.n2 - 2) / t.n2 + 1;    // a block's rows, at most
  const size_t smem = sizeof(int) * rows * 2 * kMaxTables * (size_t)(t.s + 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long gx = ((long long)t.R * t.n2 + kThreads * VEC - 1) / (kThreads * VEC);
  const dim3 grid((unsigned)gx, (t.TB + TPT - 1) / TPT, t.B);
  history_kernel<VEC, TPT, UNR><<<grid, kThreads, smem, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_history_table_bytes() { return (int)sizeof(HistTable); }

extern "C" int ccj_history_limits(int* out) {
  out[0] = kMaxWindows;
  out[1] = kMaxParts;
  out[2] = kMaxSegs;
  out[3] = kMaxTables;
  return 0;
}

// Every scan of `table` (one HistTable) in one launch on `stream`: cells
// (VEC), tt rows (TPT) and spans issued together (UNR) a thread (2, 2, 8)
// where `vec2_ok` (the caller's finding that n2, the strides and the views
// allow 4-byte loads), else (1, 2, 16).  Returns cudaGetLastError() after
// the launch: 0 on success.
extern "C" int ccj_history_min(void* table, int vec2_ok, void* stream) {
  HistTable t;
  std::memcpy(&t, table, sizeof(t));
  if (t.nwin < 1 || t.nwin > kMaxWindows || t.nseg < 0 || t.nseg > kMaxSegs || t.B < 1 ||
      t.B > 65535 || t.TB < 1 || t.R < 1 || t.n2 < 1 || t.s < 0)
    return (int)cudaErrorInvalidValue;
  for (int w = 0; w < t.nwin; ++w) {
    const HistWin& W = t.w[w];
    if (W.nparts < 0 || W.nparts > kMaxParts || W.nout < 1 || W.nout > 2 ||
        (W.mode != 0 && W.mode != 1))
      return (int)cudaErrorInvalidValue;
    for (int q = 0; q < W.nout; ++q)
      if (W.tab[q] < 0 || W.tab[q] >= kMaxTables) return (int)cudaErrorInvalidValue;
    for (int p = 0; p < W.nparts; ++p)
      if (W.seg[p] >= t.nseg) return (int)cudaErrorInvalidValue;
  }
  for (int g = 0; g < t.nseg; ++g)      // weights exist for d in [1, s] only; 32-bit span offsets
    if (t.seg[g].d0 > t.s || t.seg[g].U > t.seg[g].d0 ||
        (long long)t.seg[g].U * (t.seg[g].ws[2] < 0 ? -t.seg[g].ws[2] : t.seg[g].ws[2]) >=
            (1LL << 31))
      return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return vec2_ok ? launch<2, 2, 8>(t, st) : launch<1, 2, 16>(t, st);
}
