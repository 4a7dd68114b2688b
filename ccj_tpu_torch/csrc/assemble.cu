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
// cell, j fastest, a block 256 consecutive cells of the flattened [B, TB,
// IB, n2] planes, so a warp's loads of the 18 int32 planes (the history
// scans, pl_int, pr_int) and its stores of the 13 outputs are aligned,
// contiguous runs of the same cells; the plane reads are contiguous along
// j too (every view's j axis is contiguous; the wrapper refuses one that
// is not).  The PR branch reads the tables at (k, l), k = j + tt + 2: a
// warp's lanes on consecutive k walk down a column, a sector a lane.
// Copies of the tables transposed in storage, which make those reads
// contiguous, measured no faster on an H100 (0.0811 against 0.0807 ms at
// n=200 span 135), and staging column l in shared memory would not cut
// them, each (k, l) being read by one cell of a block; so the kernel reads
// the tables as they are.  The 16 history planes share one set of strides
// (the wrapper checks it), so a cell's offset into all 16 is one 32-bit
// sum, and each plane read's (c, b, di, dj) is a compile-time constant; a
// cell off the span's valid ones writes its constants and the PMmloop10
// base and reads nothing else.  A cell's 13 outputs stay in registers
// until its last load: stored as they were computed, each store held the
// later loads behind it (the outputs might alias the operands), and the
// kernel took 56 registers and 1.2-1.3x the time on an H100.  What binds
// it is the 36 B of output and the 8 B of PMmloop10 base every cell
// moves (80 % of its bytes at n=200), in flight behind the valid cells'
// chains of dependent loads.  Measured slower on an H100: two cells a
// thread (1.1-1.5x); a warp of 8 rows x 4 quads of 4 cells, its outputs as
// vectors into row-padded buffers and each plane read's row pointer found
// once a thread (128 registers, a quarter of the warps resident;
// 1.6-2.1x); a block of 8 rows x 32 columns, a cell a thread, so that the
// tables' (k, l) reads met 8 consecutive l (each row starts off a 128-byte
// line, so every warp's int32 loads and stores straddle two; 1.1-1.5x).
// (Figures: PERF.md.)

#include <cuda_runtime.h>


namespace {

constexpr int kReads = 13;              // cuda_ops.ASSEMBLE_READS
constexpr int kParts = 2;               // cuda_ops.PLANE_MAX_PARTS
constexpr int kHist = 16;               // cuda_ops.ASSEMBLE_HISTORY
constexpr int kOut32 = 5;
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
// cuda_ops.ASSEMBLE_READS' order, and each read's (c, b, di, dj)
enum Read_ {
  rPL, rPLm10, rPLm01, rPfromL, rPR, rPRm10, rPRm01, rPfromR, rPO, rPOm10, rPOm01,
  rPfromO, rPRm01b
};
__host__ __device__ constexpr int read_c(int q) { return q < rPO ? 1 : 0; }
__host__ __device__ constexpr int read_b(int q) { return q >= rPO && q < rPRm01b ? 2 : 1; }
__host__ __device__ constexpr int read_di(int q) {
  return q < rPR || (q >= rPO && q < rPRm01b) ? 1 : 0;
}
__host__ __device__ constexpr int read_dj(int q) { return q < rPR ? -1 : 0; }

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py (AssembleTable):
// every 64-bit field first, then the 32-bit ones, so the wrapper packs it
// with one struct format.
struct AssembleTable {
  const short* pp[kReads][kParts];      // part views int16 [B, TT, R, n2], unit j stride
  long long pst0[kReads][kParts];       // their b strides
  long long pst1[kReads][kParts];       // their tt strides
  const int* hist[kHist];               // [B, TB, IB, n2], strides hs
  const int* pl;                        // the PL / PR interior stencils, strides pls, prs
  const int* pr;
  const unsigned char* canp;            // [B, n2, n2] tables, strides ts (unit columns)
  const int* ptype;
  const int* estp;
  int* out32;                 // 5 planes [B, TB, IB, n2], one after another: PLs, PRs,
  short* out16;               // POs, mdp0, the PMmloop10 base; 8: cuda_ops.ASSEMBLED packed
  int pst2[kReads][kParts];             // the parts' row strides
  int pTT[kReads][kParts], pR[kReads][kParts];
  int pt0[kReads][kParts], pr0[kReads][kParts];   // plane row r, tt: view row r + r0, tt + t0
  int nparts[kReads];
  int hs[3], pls[3], prs[3];            // b, tt, row strides of hist, pl, pr
  int ts[2];                            // b, row strides of the tables
  int B, TB, IB, n2, n, s, i0, ap, bp, cp, PB;
};

// read q at (tt, row r, column j + dj), INF where its bounds do not admit
// the cell, SAT16 where no part holds it
__device__ __forceinline__ int rp(const AssembleTable& t, int q, int b, int tt, int r, int i,
                                  int j) {
  const int c = read_c(q), dj = read_dj(q);
  const int i2 = i + read_di(q), j2 = j + dj, u = t.s - read_b(q);
  const int k2 = j2 + tt + c + 2, l2 = i2 + u;
  if (!(i2 >= 1 && i2 <= j2 && k2 <= l2 && l2 <= t.n && u >= 0)) return kINF;
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    if (p >= t.nparts[q]) break;
    const int vr = r + t.pr0[q][p];
    if (vr < 0 || vr >= t.pR[q][p]) continue;
    const int vt = tt + t.pt0[q][p];
    if (vt < 0 || vt >= t.pTT[q][p]) return kSAT16;
    return __ldg(t.pp[q][p] + b * t.pst0[q][p] + vt * t.pst1[q][p] + vr * t.pst2[q][p] + j2);
  }
  return kSAT16;
}

__device__ __forceinline__ int enc(int v) { return min(max(v, -32768), kSAT16); }

// Cell e of the flattened [B, TB, IB, n2] planes: its 5 int32 and 8 int16
// outputs.
__device__ __forceinline__ void assemble_cell(const AssembleTable& t, int e, int* o32,
                                              int* o16) {
  const int j = e % t.n2;
  int rest = e / t.n2;
  const int r = rest % t.IB;
  rest /= t.IB;
  const int tt = rest % t.TB, b = rest / t.TB;
  const int s = t.s, i = t.i0 + r, l = i + s, k = j + tt + 2;
  const int h = b * t.hs[0] + tt * t.hs[1] + r * t.hs[2] + j;   // the cell in the 16 hist planes
  o32[4] = min(__ldg(t.hist[kPMm10ri] + h), __ldg(t.hist[kPMm10rl] + h));
  if (!(i >= 1 && j >= i && k <= l && l <= t.n)) {    // not a valid cell
    o32[0] = o32[1] = o32[2] = kINF;
    o32[3] = kINF + t.PB;
#pragma unroll
    for (int q = 0; q < kOut16; ++q) o16[q] = kSAT16;
    return;
  }
  const int bp = t.bp, ml = t.ap + t.bp, ts1 = t.ts[1], tb = b * t.ts[0];
  const int ij = tb + i * ts1 + j, il = tb + i * ts1 + l, kl = tb + k * ts1 + l;
  // ---- PL ------------------------------------------------------------------
  int PLv = kINF;
  if (__ldg(t.ptype + ij) > 0) {
    int iloop = kINF;
    if (__ldg(t.canp + ij) > 0) {
      const int st = i + kTurn + 2 < j ? rp(t, rPL, b, tt, r, i, j) + __ldg(t.estp + ij) : kINF;
      iloop = min(st, __ldg(t.pl + b * t.pls[0] + tt * t.pls[1] + r * t.pls[2] + j));
    }
    const int mv = min(rp(t, rPLm10, b, tt, r, i, j), rp(t, rPLm01, b, tt, r, i, j)) + ml;
    const int b3 = j >= i + kTurn + 1 ? rp(t, rPfromL, b, tt, r, i, j) : kINF;
    PLv = min(min(iloop, mv + bp), b3);
  }
  // ---- PR ------------------------------------------------------------------
  int PRv = kINF;
  if (__ldg(t.ptype + kl) > 0) {
    int iloop = kINF;
    if (__ldg(t.canp + kl) > 0) {
      const int st = k + kTurn + 2 < l ? rp(t, rPR, b, tt, r, i, j) + __ldg(t.estp + kl)
                                       : kINF;
      iloop = min(st, __ldg(t.pr + b * t.prs[0] + tt * t.prs[1] + r * t.prs[2] + j));
    }
    const int mv = min(rp(t, rPRm10, b, tt, r, i, j), rp(t, rPRm01, b, tt, r, i, j)) + ml;
    const int b3 = l >= k + kTurn + 1 ? rp(t, rPfromR, b, tt, r, i, j) : kINF;
    PRv = min(min(iloop, mv + bp), b3);
  }
  // ---- PO ------------------------------------------------------------------
  int POv = kINF;
  if (__ldg(t.ptype + il) > 0) {
    int iloop = kINF;
    if (__ldg(t.canp + il) > 0 && i < j && k < l)
      iloop = rp(t, rPO, b, tt, r, i, j) + __ldg(t.estp + il);
    const int mv = min(rp(t, rPOm10, b, tt, r, i, j), rp(t, rPOm01, b, tt, r, i, j)) + ml;
    const int b3 = l >= i + kTurn + 1 ? rp(t, rPfromO, b, tt, r, i, j) : kINF;
    POv = min(min(iloop, mv + bp), b3);
  }
  const int PLs = enc(PLv), PRs = enc(PRv);
  // ---- the cross-span-only families --------------------------------------
  const int POm00 = min(kSAT16 + bp, min(__ldg(t.hist[kPOm00ri] + h),
                                         __ldg(t.hist[kPOm00rl] + h)));
  const int POm01 = __ldg(t.hist[kPOm01] + h);
  const int POm10 = min(__ldg(t.hist[kPOm10ri] + h), __ldg(t.hist[kPOm10rl] + h));
  const int PRm01 = min(rp(t, rPRm01b, b, tt, r, i, j) + t.cp, __ldg(t.hist[kPRm01] + h));
  const int PfromO = min(min(__ldg(t.hist[kPfromOri] + h), __ldg(t.hist[kPfromOrl] + h)),
                         min(PLs, PRs) + t.PB);
  o32[0] = PLs;
  o32[1] = PRs;
  o32[2] = enc(POv);
  o32[3] = min(PLs, PRs) + t.PB;
  o16[0] = PLs;
  o16[1] = PRs;
  o16[2] = enc(POv);
  o16[3] = enc(PRm01);
  o16[4] = enc(POm00);
  o16[5] = enc(POm01);
  o16[6] = enc(POm10);
  o16[7] = enc(PfromO);
}

__global__ void __launch_bounds__(kThreads)
assemble_kernel(const __grid_constant__ AssembleTable t, int cells) {
  const int e = (int)blockIdx.x * kThreads + (int)threadIdx.x;
  if (e >= cells) return;
  int o32[kOut32], o16[kOut16];
  assemble_cell(t, e, o32, o16);        // every load before the first store
#pragma unroll
  for (int q = 0; q < kOut32; ++q) t.out32[q * cells + e] = o32[q];
#pragma unroll
  for (int q = 0; q < kOut16; ++q) t.out16[q * cells + e] = (short)o16[q];
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_assemble_table_bytes() { return (int)sizeof(AssembleTable); }

// (reads, parts a read, history planes): checked against cuda_ops'
// constants at load.
extern "C" void ccj_assemble_limits(int* out) {
  out[0] = kReads;
  out[1] = kParts;
  out[2] = kHist;
}

// Each plane read's (c, b, di, dj), in order: checked against
// cuda_ops.ASSEMBLE_READS at load.
extern "C" void ccj_assemble_reads(int* out) {
  for (int q = 0; q < kReads; ++q) {
    out[4 * q] = read_c(q);
    out[4 * q + 1] = read_b(q);
    out[4 * q + 2] = read_di(q);
    out[4 * q + 3] = read_dj(q);
  }
}

// One span's assembly from `table` (one AssembleTable) on `stream`.
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int ccj_span_assemble(const void* table, void* stream) {
  const AssembleTable* t = static_cast<const AssembleTable*>(table);
  const long long cells = (long long)t->B * t->TB * t->IB * t->n2;
  if (t->B < 1 || t->TB < 1 || t->IB < 1 || t->n2 < 1 || cells * kOut16 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < kReads; ++q)
    if (t->nparts[q] < 0 || t->nparts[q] > kParts) return (int)cudaErrorInvalidValue;
  assemble_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(*t, (int)cells);
  return (int)cudaGetLastError();
}
