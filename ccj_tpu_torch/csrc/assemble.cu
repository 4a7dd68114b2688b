// span_assemble: the gapped step's cross-span assembly of one span, every
// tt, row and batch element in one launch, hand-written for Hopper
// (sm_90a).
//
// Per cell (b, tt, r, j) of the span's [B, TB, IB, n2] planes, row r being
// i = i0 + r, with k = j + tt + 2 and l = i + s (pseudo_loop.cc's PL / PR /
// PO recurrences and the cross-span-only families, branch by branch as
// gapped4.span_families assembled them):
//
//   PLv = pt(i, j) > 0 ? min(canp(i, j) > 0 ? min(PL' + ESTP(i, j), pl_int) : INF,
//                            min(PLmloop10', PLmloop01') + ap + 2 bp, PfromL') : INF
//   PRv = the same over (k, l) with PR', pr_int, PRmloop10', PRmloop01', PfromR'
//   POv = pt(i, l) > 0 ? min(canp(i, l) > 0 ? PO' + ESTP(i, l) : INF,
//                            min(POmloop10', POmloop01') + ap + 2 bp, PfromO') : INF
//   POm00 = min(SAT16 + bp, H[POm00_ri], H[POm00_rl]), POm01 = H[POm01],
//   POm10 = min(H[POm10_ri], H[POm10_rl]), PRm01 = min(PRmloop01'' + cp, H[PRm01]),
//   PfromO = min(H[PfromO_ri], H[PfromO_rl], PLs + PB, PRs + PB)
//
// where X' is a fixed-offset read of family X, X[tt + c, s - b, i + di, j +
// dj] on the cells its own bounds admit (i2 >= 1, i2 <= j2, k2 <= l2 <= n,
// s - b >= 0) and INF elsewhere, each term behind its own bound (PL' needs
// i + 5 < j, PfromL' j >= i + 4, ...), and H the span's history scans.
// Outputs: PLs / PRs / POs (int32: clamp(v, -32768, 32767) on the valid
// cells, INF elsewhere), mdp0 = min(PLs, PRs) + PB, the PMmloop10 base
// min(H[PMmloop10_ri], H[PMmloop10_rl]) on every cell, and the eight
// cross-span families packed to int16 (the clamped value on the valid
// cells, SAT16 elsewhere): everything the tt loop and the store read.
//
// State reads.  Each of the 13 fixed-offset reads comes in place from the
// state through at most two int16 views [B, TTv, Rv, n2] (the layout's
// plane: the dense family at span s - b, a packed segment's block, a
// family kept only as its C skew, a row shard's own rows and its halo),
// plane row r and tt being view row r + r0 and tt + t0; a cell no part
// holds reads SAT16, which takes part as a value.  The pair planes come
// from the [B, n2, n2] tables (can_pair, ptype, ESTP) in the kernel.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusion of
// the JAX package's span body around its reductions,
// ccj_tpu/engine/gapped4.py:257-466 (and gapped5.span_gapped7's packed
// reads), which the port ran as ~480 eager PyTorch ops a span
// (cuda_ops.span_assemble_ref, the plain version).
//
// Bound: bytes.  A valid cell reads its admitted plane elements (2 B
// each), pl_int, pr_int and 15 history planes (4 B each) and six table
// entries; every cell writes 5 int32 and 8 int16 outputs and reads the two
// PMmloop10 scans.  No arithmetic is worth counting.  Design: a thread a
// cell, j fastest, so a warp reads and writes 32 consecutive j of every
// plane (every view's j axis is contiguous; the wrapper refuses one that
// is not); a cell outside the span's valid cells writes its constants and
// the PMmloop10 base and reads nothing else.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kReads = 13;              // cuda_ops.ASSEMBLE_READS
constexpr int kParts = 2;               // cuda_ops.PLANE_MAX_PARTS
constexpr int kHist = 16;               // cuda_ops.ASSEMBLE_HISTORY
constexpr int kOut16 = 8;               // cuda_ops.ASSEMBLED
constexpr int kSAT16 = 32767;
constexpr int kINF = 10000000;
constexpr int kTurn = 3;                // common.TURN
constexpr int kThreads = 256;

// cuda_ops.ASSEMBLE_HISTORY's order
enum Hist {
  kPOm00ri, kPOm00rl, kPOm01, kPOm10ri, kPOm10rl, kPRm01, kPfromOri, kPfromOrl,
  kPLm00, kPLm10, kPRm00, kPMm01, kPMm10ri, kPMm10rl, kPfromL, kPfromR
};
// cuda_ops.ASSEMBLE_READS' order
enum Read_ {
  rPL, rPLm10, rPLm01, rPfromL, rPR, rPRm10, rPRm01, rPfromR, rPO, rPOm10, rPOm01,
  rPfromO, rPRm01b
};

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py.
struct Part {                 // AssemblePart: int16 [B, TT, R, n2]
  const short* p;
  long long st[4];
  int TT, R, t0, r0;          // plane row r, tt: view row r + r0, tt + t0
};
struct Read {                 // AssembleRead
  Part part[kParts];
  int nparts, c, b, di, dj;
};
struct Plane {                // Plane: int32 [B, TB, IB, n2], any strides
  const int* p;
  long long s[4];
};
struct AssembleTable {
  Read rd[kReads];
  Plane hist[kHist];
  Plane pl, pr;               // the PL / PR interior stencils
  const void* tab[3];         // can_pair (bool), ptype, ESTP (int32) [B, n2, n2]
  long long ts[3][3];
  int* out32;                 // [5, B, TB, IB, n2]: PLs, PRs, POs, mdp0, PMmloop10 base
  short* out16;               // [8, B, TB, IB, n2]: cuda_ops.ASSEMBLED packed
  int B, TB, IB, n2, n, s, i0, ap, bp, cp, PB;
};

__device__ __forceinline__ int at(const Plane& x, int b, int tt, int r, int j) {
  return __ldg(x.p + b * x.s[0] + tt * x.s[1] + r * x.s[2] + j * x.s[3]);
}

// read q at (tt, row r, column j + dj), INF where its bounds do not admit
// the cell, SAT16 where no part holds it
__device__ __forceinline__ int rp(const AssembleTable& t, int q, int b, int tt, int r, int i,
                                  int j) {
  const Read& R = t.rd[q];
  const int i2 = i + R.di, j2 = j + R.dj, u = t.s - R.b;
  const int k2 = j2 + tt + R.c + 2, l2 = i2 + u;
  if (!(i2 >= 1 && i2 <= j2 && k2 <= l2 && l2 <= t.n && u >= 0)) return kINF;
  for (int p = 0; p < R.nparts; ++p) {
    const Part& P = R.part[p];
    const int vr = r + P.r0;
    if (vr < 0 || vr >= P.R) continue;
    const int vt = tt + P.t0;
    if (vt < 0 || vt >= P.TT) return kSAT16;
    return __ldg(P.p + b * P.st[0] + vt * P.st[1] + vr * P.st[2] + j2 * P.st[3]);
  }
  return kSAT16;
}

__device__ __forceinline__ int tab(const AssembleTable& t, int k, int b, int x, int y) {
  const long long o = b * t.ts[k][0] + x * t.ts[k][1] + y * t.ts[k][2];
  return k == 0 ? (int)__ldg(static_cast<const unsigned char*>(t.tab[0]) + o)
                : __ldg(static_cast<const int*>(t.tab[k]) + o);
}

__device__ __forceinline__ int enc(int v) { return min(max(v, -32768), kSAT16); }

__global__ void __launch_bounds__(kThreads)
assemble_kernel(const __grid_constant__ AssembleTable t, int cells) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= cells) return;
  const int j = e % t.n2;
  int rest = e / t.n2;
  const int r = rest % t.IB;
  rest /= t.IB;
  const int tt = rest % t.TB;
  const int b = rest / t.TB;
  const int i = t.i0 + r;
  const int s = t.s;
  const int k = j + tt + 2, l = i + s;
  const long long plane = (long long)t.B * t.TB * t.IB * t.n2;
  int* o32 = t.out32 + e;
  short* o16 = t.out16 + e;
  o32[4 * plane] = min(at(t.hist[kPMm10ri], b, tt, r, j), at(t.hist[kPMm10rl], b, tt, r, j));
  if (!(i >= 1 && j >= i && k <= l && l <= t.n)) {    // not a valid cell
    o32[0] = o32[plane] = o32[2 * plane] = kINF;
    o32[3 * plane] = kINF + t.PB;
#pragma unroll
    for (int q = 0; q < kOut16; ++q) o16[q * plane] = (short)kSAT16;
    return;
  }
  const int bp = t.bp, ml = t.ap + t.bp;
  // ---- PL ------------------------------------------------------------------
  int PLv = kINF;
  if (tab(t, 1, b, i, j) > 0) {
    int iloop = kINF;
    if (tab(t, 0, b, i, j) > 0) {
      const int st = i + kTurn + 2 < j ? rp(t, rPL, b, tt, r, i, j) + tab(t, 2, b, i, j) : kINF;
      iloop = min(st, at(t.pl, b, tt, r, j));
    }
    const int mv = min(rp(t, rPLm10, b, tt, r, i, j), rp(t, rPLm01, b, tt, r, i, j)) + ml;
    const int b3 = j >= i + kTurn + 1 ? rp(t, rPfromL, b, tt, r, i, j) : kINF;
    PLv = min(min(iloop, mv + bp), b3);
  }
  // ---- PR ------------------------------------------------------------------
  int PRv = kINF;
  if (tab(t, 1, b, k, l) > 0) {
    int iloop = kINF;
    if (tab(t, 0, b, k, l) > 0) {
      const int st = k + kTurn + 2 < l ? rp(t, rPR, b, tt, r, i, j) + tab(t, 2, b, k, l) : kINF;
      iloop = min(st, at(t.pr, b, tt, r, j));
    }
    const int mv = min(rp(t, rPRm10, b, tt, r, i, j), rp(t, rPRm01, b, tt, r, i, j)) + ml;
    const int b3 = l >= k + kTurn + 1 ? rp(t, rPfromR, b, tt, r, i, j) : kINF;
    PRv = min(min(iloop, mv + bp), b3);
  }
  // ---- PO ------------------------------------------------------------------
  int POv = kINF;
  if (tab(t, 1, b, i, l) > 0) {
    int iloop = kINF;
    if (tab(t, 0, b, i, l) > 0 && i < j && k < l)
      iloop = rp(t, rPO, b, tt, r, i, j) + tab(t, 2, b, i, l);
    const int mv = min(rp(t, rPOm10, b, tt, r, i, j), rp(t, rPOm01, b, tt, r, i, j)) + ml;
    const int b3 = l >= i + kTurn + 1 ? rp(t, rPfromO, b, tt, r, i, j) : kINF;
    POv = min(min(iloop, mv + bp), b3);
  }
  const int PLs = enc(PLv), PRs = enc(PRv);
  // ---- the cross-span-only families --------------------------------------
  const int POm00 = min(kSAT16 + bp, min(at(t.hist[kPOm00ri], b, tt, r, j),
                                         at(t.hist[kPOm00rl], b, tt, r, j)));
  const int POm01 = at(t.hist[kPOm01], b, tt, r, j);
  const int POm10 = min(at(t.hist[kPOm10ri], b, tt, r, j), at(t.hist[kPOm10rl], b, tt, r, j));
  const int PRm01 = min(rp(t, rPRm01b, b, tt, r, i, j) + t.cp, at(t.hist[kPRm01], b, tt, r, j));
  const int PfromO = min(min(at(t.hist[kPfromOri], b, tt, r, j),
                             at(t.hist[kPfromOrl], b, tt, r, j)),
                         min(PLs, PRs) + t.PB);
  o32[0] = PLs;
  o32[plane] = PRs;
  o32[2 * plane] = enc(POv);
  o32[3 * plane] = min(PLs, PRs) + t.PB;
  const int packed[kOut16] = {PLs, PRs, POv, PRm01, POm00, POm01, POm10, PfromO};
#pragma unroll
  for (int q = 0; q < kOut16; ++q) o16[q * plane] = (short)enc(packed[q]);
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_assemble_table_bytes() { return (int)sizeof(AssembleTable); }

// (reads, parts a read, history planes): checked against cuda_ops' constants
// at load.
extern "C" void ccj_assemble_limits(int* out) {
  out[0] = kReads;
  out[1] = kParts;
  out[2] = kHist;
}

// One span's assembly from `table` (one AssembleTable) on `stream`.
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int ccj_span_assemble(const void* table, void* stream) {
  AssembleTable t;
  std::memcpy(&t, table, sizeof(t));
  const long long cells = (long long)t.B * t.TB * t.IB * t.n2;
  if (t.B < 1 || t.TB < 1 || t.IB < 1 || t.n2 < 1 || cells >= (1LL << 31) / 8)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < kReads; ++q)
    if (t.rd[q].nparts < 0 || t.rd[q].nparts > kParts) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((cells + kThreads - 1) / kThreads);
  assemble_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(t, (int)cells);
  return (int)cudaGetLastError();
}
