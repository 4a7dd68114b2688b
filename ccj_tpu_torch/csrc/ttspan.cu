// tt_span: a whole span's serial tt loop in one launch, hand-written for
// Hopper (sm_90a).  For span s it runs tt = s - 2 down to 0, and each step
// computes what minplus_group (csrc/minplus.cu) and tt_step (csrc/ttstep.cu)
// compute in their two launches per step:
//
//   - the step's 13 k-shrink / j-shrink min-plus reductions
//     (ttloop.REDUCTIONS), each
//       red[g][j] = min(INF, min over admissible q of slab[tt + 1 + q, r, col] + w[q, wcol])
//     with red_k reading a family at column j and weight column tt + 2 + j,
//     red_j the family at column j - 1 - q and weight column j;
//   - the assembly of the 14 families' row tt, the PM interior stencil and
//     the store encoding enc(v) = clamp(v, -32768, SAT16), exactly as
//     tt_step; then the write-back of row tt.
//
// Replaces, on the port's main path: the TPU kernel
// ccj_tpu/engine/pallas_ops.py:_minplus_kernel (launched by minplus_suffix,
// pl.pallas_call at :70), whose function is the loop's red_k / red_j
// (ccj_tpu/engine/ttloop.py:442-455), and the XLA fusion of the rest of the
// JAX loop body (ttloop.py:457-551); the JAX package runs the whole loop as
// one device program per span (jax.lax.fori_loop, ttloop.py:553).
// Plain version: cuda_ops.tt_span_ref, the loop of minplus_group_ref and
// tt_step_ref.
//
// The valid band.  A cell (tt, i, j) is valid iff i >= 1, i + s <= n (a
// live row), and 0 <= d = j - i <= s - 2 - tt (gapped4.span_families'
// valid4, computed here from n).  Every cell outside it stores INF; the
// caller initialises the family slabs so (ttloop._run_span: SAT16 on valid
// cells, INF elsewhere) and the kernel never writes there: not the dead
// rows (the grid has none), not rows [0, s - 2] outside the band, not rows
// >= s - 1.  A live row's band is the triangle (x, d), d <= s - 2 - x, of
// (s - 1) s / 2 cells.  The kernel computes only:
//   - the live rows: one block per (b, i), i in [max(1, i0), min(i0 + IB -
//     1, n - s)];
//   - the valid cells: a step computes d in [0, s - 2 - tt];
//   - the terms whose source cell lies in the band: red_k q <= s - 3 - tt -
//     d (s - 4 - tt - d masked), red_j q <= d - 1 (d - 2 masked); the PM
//     stencil's own bounds keep it inside.
// A skipped term reads a cell outside the band, which holds INF: it is
// INF + w with |w| << INF - SAT16, so it can win a reduction only where no
// in-band term did, and then the result is above SAT16 either way.  A
// reduction enters the assembly only through min() and the store clamps
// everything above SAT16 to SAT16 (every computed cell is valid), so every
// stored row is bit-equal to the plain loop's.  mdp is read only by a
// masked red_k, whose terms all lie in the band.
//
// On chip.  A row's band of the 8 families the reductions read (PLmloop00,
// PLmloop10, PRmloop00, PMmloop00, PfromL, PfromR, PfromMprime, PK) and of
// PM, which the stencil reads at rows tt + 2 .. tt + 2 DS, lives in shared
// memory as int16 (stored values at valid cells lie in [-32768, SAT16]);
// mdp's band as int32 (min(PL, PR) + PB passes 32767), loaded once with
// cp.async at the start.  Each step writes its row tt into the band and,
// once, into device memory.  The previous-row reads of PRmloop10,
// PMmloop01, PMmloop10 and PfromM (rows tt + 1, tt + 2) come from a
// three-row ring.  A step is two barriers: the reductions and the stencil,
// as warp tasks meeting in shared memory by atomicMin (exact and
// order-free), then the assembly, one thread per cell.  Where a row's band
// is larger than a block's shared memory (about s > 140), its rows [0, xs)
// stay on chip and the oldest rows, x >= xs, are read from device memory
// where the kernel wrote them (kFit false).  A span with few live rows
// gives each a thread-block cluster of 2 or 4 blocks (kC): every block
// holds the whole band and assembles every cell itself, the step's tasks
// are shared out, and a cell's partial minima are the minimum over the
// blocks' shared memories (DSMEM), double-buffered by the step's parity
// so that one cluster.sync() a step suffices.  The weights (WKX, WJX;
// i stride 0) are read through __ldg, or, where they fit beside the band,
// staged once per row into shared memory with cp.async: in (q, tt + d)
// coordinates a row's weight terms are the same triangle at every step
// (kStage).  DPM (no i axis) is read through __ldg from L2.
//
// Coherence.  The family slabs are written by the launch and read back
// (rows >= xs) only after the reading block wrote the same values itself
// (every block of a cluster writes them where it reads them back), after
// __syncthreads(), with plain loads (__ldcg in a cluster); only operands no
// one writes (mdp, the weights, the bases, PL / PR / PO, jk, DPM) take the
// read-only path.
//
// Bound.  chip_smoke.py's span_bound: the span's loop as one function on
// this contract, each input element that an in-band term or a valid cell
// needs read once and the valid cells of the live rows of the 14 families
// written once, over the 3.35 TB/s memory rate (bytes bound it; the adds
// and mins are a fraction of the int32 rate).  The kernel's
// device-memory traffic is that, plus DPM and (unstaged) the weights from
// L2 at every step: its time is the latency chain of s - 1 steps, each two
// barriers and a few shared-memory passes per warp, on as many SMs as
// there are live rows (times the cluster).
//
// Limits: n2 <= kMaxN2, s <= n <= n2 + 1 (every band cell of a live row
// lies in a column < n2), at most kMaxJobs descriptors, batch <= 65535
// (grid.y).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace cg = cooperative_groups;

namespace {

constexpr int kDS = 29;                 // gapped.DS: stencil offsets 1..29
constexpr int kReductions = 13;         // ttloop.REDUCTIONS
constexpr int kBases = 7;               // cuda_ops.STEP_BASES
constexpr int kFamilies = 14;           // cuda_ops.STEP_FAMILIES
constexpr int kWeights = 6;             // WKX (WP, WB, WBP), then WJX (WP, WB, WBP)
constexpr int kMaxJobs = 16;
constexpr int kMaxN2 = 512;
constexpr int kBandFams = 9;            // the 8 reduction sources and PM
constexpr int kRingFams = 4;            // PRmloop10, PMmloop01, PMmloop10, PfromM
constexpr int kRingRows = 3;            // rows tt + 1, tt + 2 read, row tt written
constexpr int kQChunk = 32;             // q values of one reduction task
constexpr int kClusterSpan = 48;        // spans from which a row may take a cluster:
                                        // 2 blocks a row lost at s = 37 and won at s = 65
constexpr int kMaxThreads = 1024;
using TBand = int16_t;                  // the band: stored values at valid cells lie in
                                        // [-32768, SAT16]

enum Family {
  PLmloop00, PLmloop01, PLmloop10, PRmloop00, PRmloop10, PMmloop00,
  PMmloop01, PMmloop10, PM, PfromL, PfromR, PfromM, PfromMprime, PK
};
enum Base { bPLmloop00, bPLmloop10, bPRmloop00, bPMmloop01, bPMmloop10, bPfromL, bPfromR };
enum Ring { rPRmloop10, rPMmloop01, rPMmloop10, rPfromM };

// A family's plane in the band (-1: not held there).
__host__ __device__ constexpr int band_slot(int f) {
  return f == PLmloop00 ? 0 : f == PLmloop10 ? 1 : f == PRmloop00 ? 2 : f == PMmloop00 ? 3
       : f == PfromL ? 4 : f == PfromR ? 5 : f == PfromMprime ? 6 : f == PK ? 7
       : f == PM ? 8 : -1;
}

// One operand: base pointer and element strides over (batch, row, i, j).
// Mirrored by ccj_tpu_torch/engine/cuda_ops.py:Plane.
struct Plane {
  void* p;
  long long s[4];
};

// One reduction descriptor, mirrored by cuda_ops.py:SpanJob.  kind 0 is
// red_k (family `src`, rows tt + 1 + q, column j; weight column tt + 2 +
// j), kind 1 is red_j (family `src` at column j - 1 - q; weight column j).
// A second weight table w2 (-1: none) on the same terms feeds a second
// output.
struct Job {
  int src;                    // family index; kFamilies is mdp
  int kind, masked;
  int w, out, w2, out2;
};

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py:SpanTable.
struct SpanTable {
  Plane cur[kFamilies];       // family slabs [B, R, IB, n2]
  Plane mdp;                  // [B, R, IB, n2], read only
  Plane wt[kWeights];         // [B, Q, cols] (i stride 0)
  Plane base[kBases];         // [B, T, IB, n2], read at row tt
  Plane jk[3];                // canp, ptype, ESTP rows [B, T, n2] (i stride 0)
  Plane pl, pr, po;           // [B, T, IB, n2]
  const int* dpm;             // [B, DS, DS, T, U]
  long long dpm_s[5];
  Job jobs[kMaxJobs];
  int njobs, B, n, s, i0, IB, n2, Q, bp, cp, ap, PB, SAT16, INF;
};

// The launch's knobs and what it launched, mirrored by cuda_ops.py:SpanPlan.
struct SpanPlan {
  int threads;   // in: threads a block, 0 for the plan's; out: launched
  int cluster;   // in: blocks a row (1, 2, 4), 0 for the plan's; out: launched
  int rows;      // in: band rows held on chip at most, 0 for all that fit; out: xs
  int stage;     // in: weights staged (1) or read through __ldg (0), -1 for the plan's
  int live;      // out: live rows a batch element (0: nothing launched)
  int smem;      // out: dynamic shared memory a block, bytes
  int active;    // out: clusters of the launched size the card runs at once
};

// Byte offsets of a block's dynamic shared memory.
struct Layout {
  int ncp;                    // cells of a row's widest band row (s - 1), to 32
  int xs;                     // band rows [0, xs) are held on chip
  int nt;                     // their cells, to 8
  int nw;                     // cells of a staged weight triangle (0: not staged)
  int red, ring, mdp, band, wts, bytes;
};

__host__ __device__ __forceinline__ int band_row(int s, int x) {
  return x * (2 * s - 1 - x) / 2;       // cells of band rows [0, x)
}

__host__ __device__ __forceinline__ int weight_row(int s, int q) {
  return q * (2 * s - 3 - q) / 2;       // cells of staged weight rows [0, q)
}

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

Layout make_layout(int s, int xs, bool stage) {
  Layout L;
  L.ncp = (s - 1 + 31) & ~31;
  L.xs = xs;
  L.nt = (band_row(s, xs) + 7) & ~7;
  L.nw = stage ? (weight_row(s, s - 2) + 3) & ~3 : 0;
  L.red = 0;                                               // [2][13 + 1][ncp]: red, pmacc
  L.ring = L.red + 2 * (kReductions + 1) * L.ncp * 4;      // [4][3][ncp]
  L.mdp = L.ring + kRingFams * kRingRows * L.ncp * 4;      // [nt] int32
  L.band = L.mdp + L.nt * 4;                               // [9][nt]
  L.wts = align16(L.band + kBandFams * L.nt * (int)sizeof(TBand));   // [6][nw] int32
  L.bytes = L.wts + kWeights * L.nw * 4;
  return L;
}

__device__ __forceinline__ long long off(const Plane& P, long long b, long long row,
                                         long long i, long long j) {
  return b * P.s[0] + row * P.s[1] + i * P.s[2] + j * P.s[3];
}

// A read-only operand.
__device__ __forceinline__ int ldro(const Plane& P, long long b, long long row, int i, int j) {
  return __ldg(static_cast<const int*>(P.p) + off(P, b, row, i, j));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int min3(int a, int b, int c) { return min(min(a, b), c); }

// The block's row: its band in shared memory and where the rest lies.
struct Row {
  const SpanTable& t;
  const Layout& L;
  int* red;                   // [2][13 + 1][ncp]: a step's partial minima (pmacc last), by parity
  int* ring;                  // [4][3][ncp]
  int* mdpb;                  // [nt]
  TBand* band;                // [9][nt]
  int* wts;                   // [6][nw]
  long long b;
  int r, i;
};

// Step tt's partial minima (reduction g; kReductions: the PM stencil's).
__device__ __forceinline__ int* red_at(const Row& R, int tt, int g) {
  return R.red + ((tt & 1) * (kReductions + 1) + g) * R.L.ncp;
}

// Family f at band cell (x, d): from `plane`, f's plane of the band (mdp's
// for f = kFamilies), or, for a row past those on chip, from device memory.
template <bool kFit, int kC, typename TS>
__device__ __forceinline__ int band_at(const Row& R, const TS* plane, int f, int x,
                                       int d) {
  if (!kFit && x >= R.L.xs) {
    if (f == kFamilies) return ldro(R.t.mdp, R.b, x, R.r, R.i + d);
    const int* p = static_cast<const int*>(R.t.cur[f].p) + off(R.t.cur[f], R.b, x, R.r, R.i + d);
    return kC > 1 ? __ldcg(p) : *p;
  }
  return (int)plane[band_row(R.t.s, x) + d];
}

// Weight table w at term (q, cell d) of step tt.
template <bool kStage, int kKind>
__device__ __forceinline__ int weight_at(const Row& R, int w, int q, int tt, int d) {
  if (kStage) {
    const int e = kKind == 0 ? tt + d : d - 1 - q;
    return R.wts[w * R.L.nw + weight_row(R.t.s, q) + e];
  }
  const Plane& W = R.t.wt[w];
  const int col = kKind == 0 ? tt + 2 + R.i + d : R.i + d;
  return __ldg(static_cast<const int*>(W.p) + R.b * W.s[0] + (long long)q * W.s[1] +
               (long long)col * W.s[3]);
}

// One reduction task: lanes d = tile * 32 + lane, q in [q0, q0 + kQChunk)
// of job `job`, in-band terms only, into the partial minima of red[out]
// (and red[out2]).  kKind: 0 red_k, 1 red_j; kW: 1 or 2 weight tables.
template <bool kFit, bool kStage, int kC, int kKind, int kW, typename TS>
__device__ __forceinline__ void reduce_task(const Row& R, const TS* plane, const Job& job,
                                            int tt, int tile, int q0) {
  const int s = R.t.s, INF = R.t.INF;
  const int d = tile * 32 + (threadIdx.x & 31);
  const int hi = d > s - 2 - tt ? -1 : (kKind == 0 ? s - 3 - tt - d : d - 1) - job.masked;
  const int q1 = min(q0 + kQChunk - 1, __reduce_max_sync(0xffffffffu, hi));
  if (q1 < q0) return;
  int acc = INF, acc2 = INF;
#pragma unroll 4
  for (int q = q0; q <= q1; ++q) {
    if (q <= hi) {
      const int v = band_at<kFit, kC>(R, plane, job.src, tt + 1 + q, kKind == 0 ? d : d - 1 - q);
      acc = min(acc, v + weight_at<kStage, kKind>(R, job.w, q, tt, d));
      if (kW == 2) acc2 = min(acc2, v + weight_at<kStage, kKind>(R, job.w2, q, tt, d));
    }
  }
  if (acc < INF) atomicMin(red_at(R, tt, job.out) + d, acc);
  if (kW == 2 && acc2 < INF) atomicMin(red_at(R, tt, job.out2) + d, acc2);
}

// One stencil task: the d2 column of the PM interior stencil for the 32
// cells of tile `tile`, each lane walking its admissible d1 over PM's band
// (row tt + d1 + d2, column d - d1); the partial minimum goes to pmacc.
template <bool kFit, int kC>
__device__ __forceinline__ void stencil_task(const Row& R, int tt, int tile, int d2) {
  const SpanTable& t = R.t;
  const int d = tile * 32 + (threadIdx.x & 31);
  const int d1max = d <= t.s - 2 - tt ? min(kDS, d - 1) : 0;
  if (d1max < 1 || d2 > min(kDS, t.s - 3 - tt - d)) return;
  const int* dp = t.dpm + R.b * t.dpm_s[0] + (long long)(d2 - 1) * t.dpm_s[2] +
                  (long long)tt * t.dpm_s[3] + (long long)(R.i + d + tt) * t.dpm_s[4];
  const TBand* pm = R.band + band_slot(PM) * R.L.nt;
  int acc = t.INF;
#pragma unroll 4
  for (int d1 = 1; d1 <= d1max; ++d1) {
    acc = min(acc, band_at<kFit, kC>(R, pm, PM, tt + d1 + d2, d - d1) +
                       __ldg(dp + (long long)(d1 - 1) * t.dpm_s[1]));
  }
  if (acc < t.INF) atomicMin(red_at(R, tt, kReductions) + d, acc);
}

// Row tt's cell d: the assembly, the store encoding, the write-back into
// device memory (by rank 0 of a cluster where the band is all on chip, by
// every block where a block reads rows back: identical values), the band
// (x < xs) and the ring.  The step's partial minima are the minimum over the
// cluster's blocks (distributed shared memory).
template <bool kFit, int kC>
__device__ __forceinline__ void assemble(const Row& R, int tt, int d, int rank) {
  const SpanTable& t = R.t;
  const int s = t.s, INF = t.INF, j = R.i + d;
  const int ncp = R.L.ncp;
  int rdv[kReductions + 1];
#pragma unroll
  for (int g = 0; g <= kReductions; ++g) {
    int* own = red_at(R, tt, g) + d;
    int v = *own;
    if constexpr (kC > 1) {
      cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
      for (int c = 1; c < kC; ++c) v = min(v, *cluster.map_shared_rank(own, (rank + c) % kC));
    }
    rdv[g] = v;
  }
  // a ring family at band cell (x, dd), INF outside the band
  auto prev = [&](int k, int x, int dd) {
    return x <= s - 2 && dd >= 0 && dd <= s - 2 - x ? R.ring[(k * kRingRows + x % kRingRows) * ncp + dd]
                                                     : INF;
  };
  auto base = [&](int k) { return ldro(t.base[k], R.b, tt, R.r, j); };
  auto rd = [&](int g) { return rdv[g]; };
  const int top = t.SAT16 + t.bp;

  int out[kFamilies];
  out[PLmloop00] = min3(top, base(bPLmloop00), rd(0));
  out[PLmloop01] = rd(1);
  out[PLmloop10] = min(base(bPLmloop10), rd(2));
  out[PRmloop00] = min3(top, base(bPRmloop00), rd(3));
  out[PRmloop10] = min(prev(rPRmloop10, tt + 1, d) + t.cp, rd(4));
  out[PMmloop00] = min3(top, rd(5), rd(6));
  out[PMmloop01] = min(prev(rPMmloop01, tt + 1, d) + t.cp, base(bPMmloop01));
  out[PMmloop10] = min(prev(rPMmloop10, tt + 1, d - 1) + t.cp, base(bPMmloop10));

  const int pm_int = rd(kReductions);
  const int canp = ldro(t.jk[0], R.b, tt, 0, j);
  const int pt = ldro(t.jk[1], R.b, tt, 0, j);
  const int estp = ldro(t.jk[2], R.b, tt, 0, j);
  const bool pm_in = tt + 2 <= s - 2 && d >= 1 && d - 1 <= s - 4 - tt;
  const int pm_prev =
      pm_in ? band_at<kFit, kC>(R, R.band + band_slot(PM) * R.L.nt, PM, tt + 2, d - 1) : INF;
  const int pm_stack = pm_prev + estp;
  const int pm_iloop = canp > 0 ? min(pm_stack, pm_int) : INF;
  const int pm_mloop = min(prev(rPMmloop10, tt + 2, d - 1), prev(rPMmloop01, tt + 2, d - 1)) +
                       t.ap + t.bp;
  const int pm_b3 = prev(rPfromM, tt + 2, d - 1);
  const int pm_b4 = (d == 0 && tt == s - 2) ? 0 : INF;
  const int pmv = pt > 0 ? min(min3(pm_iloop, pm_mloop + t.bp, pm_b3), pm_b4) : INF;

  auto enc = [&](int v) { return min(max(v, -32768), t.SAT16); };   // every cell is valid
  const int pms = enc(pmv);
  const int pls = ldro(t.pl, R.b, tt, R.r, j) + t.PB;
  const int prs = ldro(t.pr, R.b, tt, R.r, j) + t.PB;
  const int pos = ldro(t.po, R.b, tt, R.r, j) + t.PB;
  out[PM] = pms;
  out[PfromL] = min(min3(base(bPfromL), rd(7), prs), min(pms + t.PB, pos));
  out[PfromR] = min(min3(base(bPfromR), rd(8), pms + t.PB), pos);
  out[PfromM] = rd(9);
  out[PfromMprime] = rd(10);
  out[PK] = min(min3(rd(11), rd(12), pls), min3(pms + t.PB, prs, pos));

  const bool on_chip = kFit || tt < R.L.xs;
  const bool writer = !kFit || rank == 0;
  const int c = band_row(s, tt) + d;
#pragma unroll
  for (int f = 0; f < kFamilies; ++f) {
    const int v = enc(out[f]);
    if (writer) static_cast<int*>(t.cur[f].p)[off(t.cur[f], R.b, tt, R.r, j)] = v;
    if (band_slot(f) >= 0 && on_chip) R.band[band_slot(f) * R.L.nt + c] = (TBand)v;
  }
  const int slot = tt % kRingRows;
  R.ring[(rPRmloop10 * kRingRows + slot) * ncp + d] = enc(out[PRmloop10]);
  R.ring[(rPMmloop01 * kRingRows + slot) * ncp + d] = enc(out[PMmloop01]);
  R.ring[(rPMmloop10 * kRingRows + slot) * ncp + d] = enc(out[PMmloop10]);
  R.ring[(rPfromM * kRingRows + slot) * ncp + d] = enc(out[PfromM]);
}

template <bool kFit, bool kStage, int kC>
__global__ void __launch_bounds__(kMaxThreads)
tt_span_kernel(const __grid_constant__ SpanTable t, const __grid_constant__ Layout L,
               int skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = t.s;
  const int rank = kC > 1 ? (int)(blockIdx.x % kC) : 0;
  const int i = max(1, t.i0) + (int)(blockIdx.x / kC);        // a live row
  const Row R{t, L, reinterpret_cast<int*>(smem + L.red),
               reinterpret_cast<int*>(smem + L.ring), reinterpret_cast<int*>(smem + L.mdp),
               reinterpret_cast<TBand*>(smem + L.band), reinterpret_cast<int*>(smem + L.wts),
               (long long)blockIdx.y, i - t.i0, i};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int gw = rank * nwarps + warp, row_warps = kC * nwarps;   // the warp among its row's

  // mdp's band (rows [0, xs)) and the staged weights, asynchronously
  for (int x = warp; x < L.xs; x += nwarps) {
    const int* src = static_cast<const int*>(t.mdp.p) + off(t.mdp, R.b, x, R.r, i);
    for (int d = lane; d <= s - 2 - x; d += 32)
      cp_async4(R.mdpb + band_row(s, x) + d, src + (long long)d * t.mdp.s[3]);
  }
  if (kStage) {
    for (int k = warp; k < kWeights * (s - 2); k += nwarps) {
      const int w = k / (s - 2), q = k % (s - 2);
      const Plane& W = t.wt[w];
      const int col0 = w < kWeights / 2 ? i + 2 : i + q + 1;   // WKX: c = tt + d; WJX: e = d - 1 - q
      const int* src = static_cast<const int*>(W.p) + R.b * W.s[0] + (long long)q * W.s[1];
      for (int e = lane; e <= s - 3 - q; e += 32)
        cp_async4(R.wts + w * L.nw + weight_row(s, q) + e, src + (long long)(col0 + e) * W.s[3]);
    }
  }
  for (int k = threadIdx.x; k < 2 * (kReductions + 1) * L.ncp; k += blockDim.x) R.red[k] = t.INF;
  cp_async_wait_all();
  if constexpr (kC > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  for (int tt = s - 2; tt >= 0; --tt) {
    // ---- the 13 reductions and the PM stencil, as independent warp tasks,
    // spread over the row's blocks ----
    const int ntile = (s - 2 - tt + 32) >> 5;                 // cells d in [0, s - 2 - tt]
    const int nqc = (s - 2 - tt + kQChunk - 1) / kQChunk;     // q in [0, s - 3 - tt]
    const int nred = (skip & 1) ? 0 : t.njobs * ntile * nqc;
    const int nd2 = (skip & 2) ? 0 : min(kDS, max(0, s - 3 - tt));
    for (int task = gw; task < nred + ntile * nd2; task += row_warps) {
      if (task < nred) {
        const int qc = task % nqc;
        const int tile = (task / nqc) % ntile;
        const Job& job = t.jobs[task / (nqc * ntile)];
        const int q0 = qc * kQChunk;
        if (job.src == kFamilies) {           // mdp: a masked red_k
          reduce_task<kFit, kStage, kC, 0, 1>(R, R.mdpb, job, tt, tile, q0);
          continue;
        }
        const TBand* plane = R.band + band_slot(job.src) * L.nt;
        if (job.kind == 0) {
          if (job.w2 >= 0) {
            reduce_task<kFit, kStage, kC, 0, 2>(R, plane, job, tt, tile, q0);
          } else {
            reduce_task<kFit, kStage, kC, 0, 1>(R, plane, job, tt, tile, q0);
          }
        } else if (job.w2 >= 0) {
          reduce_task<kFit, kStage, kC, 1, 2>(R, plane, job, tt, tile, q0);
        } else {
          reduce_task<kFit, kStage, kC, 1, 1>(R, plane, job, tt, tile, q0);
        }
      } else {
        const int k = task - nred;
        stencil_task<kFit, kC>(R, tt, k % ntile, k / ntile + 1);
      }
    }
    if constexpr (kC > 1) {
      cg::this_cluster().sync();          // every block's partial minima are in
    } else {
      __syncthreads();
    }
    // ---- the assembly and write-back of row tt, one thread per cell (in
    // every block of a cluster: each keeps the whole band); the other
    // parity's partial minima start step tt - 1 at INF ----
    const int D = s - 2 - tt;
    for (int d = threadIdx.x; d <= min(D + 1, s - 2); d += blockDim.x) {
      if (d <= D && !(skip & 4)) assemble<kFit, kC>(R, tt, d, rank);
#pragma unroll
      for (int g = 0; g <= kReductions; ++g) red_at(R, tt + 1, g)[d] = t.INF;
    }
    __syncthreads();
  }
  if constexpr (kC > 1) cg::this_cluster().sync();   // no block leaves while others read it
}

template <bool kFit, bool kStage, int kC>
int launch(const SpanTable& t, const Layout& L, int live, int threads, int skip,
           cudaStream_t stream) {
  auto* kern = tt_span_kernel<kFit, kStage, kC>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(live * kC, t.B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kC > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, t, L, skip);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of kC blocks of `threads` threads and L's shared memory
// the card runs at once (0 on an error).
template <bool kFit, bool kStage, int kC>
int active(const Layout& L, int threads) {
  auto* kern = tt_span_kernel<kFit, kStage, kC>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes) !=
      cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = L.bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// `launch` (op 0) or `active` (op 1) at a cluster size known at run time.
template <bool kFit, bool kStage>
int by_cluster(int op, int cluster, const SpanTable& t, const Layout& L, int live, int threads,
               int skip, cudaStream_t stream) {
  switch (cluster) {
    case 1: return op ? active<kFit, kStage, 1>(L, threads)
                      : launch<kFit, kStage, 1>(t, L, live, threads, skip, stream);
    case 2: return op ? active<kFit, kStage, 2>(L, threads)
                      : launch<kFit, kStage, 2>(t, L, live, threads, skip, stream);
    case 4: return op ? active<kFit, kStage, 4>(L, threads)
                      : launch<kFit, kStage, 4>(t, L, live, threads, skip, stream);
    default: return op ? 0 : (int)cudaErrorInvalidValue;
  }
}

// by_cluster for the fit and staging of a plan.
int dispatch(int op, int cluster, bool fit, bool stage, const SpanTable& t, const Layout& L,
             int live, int threads, int skip, cudaStream_t stream) {
  switch ((fit ? 2 : 0) + (stage ? 1 : 0)) {
    case 3: return by_cluster<true, true>(op, cluster, t, L, live, threads, skip, stream);
    case 2: return by_cluster<true, false>(op, cluster, t, L, live, threads, skip, stream);
    case 0: return by_cluster<false, false>(op, cluster, t, L, live, threads, skip, stream);
    default: return op ? 0 : (int)cudaErrorInvalidValue;
  }
}

// Plan and launch one span (see ccj_tt_span); `skip` leaves phases out.
int run(const void* table, const void* knobs, int skip, void* stream, void* plan) {
  SpanTable t;
  SpanPlan k, p;
  std::memcpy(&t, table, sizeof(t));
  std::memcpy(&k, knobs, sizeof(k));
  if (t.B < 1 || t.B > 65535 || t.IB < 0 || t.n2 < 1 || t.n2 > kMaxN2 || t.s < 2 ||
      t.n < t.s || t.n > t.n2 + 1 || t.Q < t.s - 2 || t.njobs < 1 || t.njobs > kMaxJobs ||
      k.threads < 0 || k.threads > kMaxThreads || k.threads % 32 != 0 || k.rows < 0 ||
      (k.cluster != 0 && k.cluster != 1 && k.cluster != 2 && k.cluster != 4))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  std::memset(&p, 0, sizeof(p));
  const int lo = t.i0 > 1 ? t.i0 : 1;
  const int hi = t.i0 + t.IB - 1 < t.n - t.s ? t.i0 + t.IB - 1 : t.n - t.s;
  p.live = hi >= lo ? hi - lo + 1 : 0;
  int xs = k.rows ? (k.rows < t.s - 1 ? k.rows : t.s - 1) : t.s - 1;
  while (xs > 0 && make_layout(t.s, xs, false).bytes > optin) --xs;
  const bool fit = xs == t.s - 1;
  p.stage = fit && k.stage != 0 && t.s > 2 && make_layout(t.s, xs, true).bytes <= optin;
  const Layout L = make_layout(t.s, xs, p.stage);
  if (L.bytes > optin) return (int)cudaErrorInvalidValue;
  p.rows = xs;
  p.smem = L.bytes;
  const long long rows = (long long)p.live * t.B;
  const cudaStream_t st = (cudaStream_t)stream;
  p.cluster = k.cluster;
  if (p.cluster == 0) {
    p.cluster = 1;
    for (int c = 4; c >= 2 && t.s >= kClusterSpan && rows > 0; c /= 2) {
      const int th = k.threads ? k.threads : 1024;
      if (rows <= dispatch(1, c, fit, p.stage, t, L, 0, th, 0, st)) {
        p.cluster = c;
        break;
      }
    }
  }
  const long long blocks = rows * p.cluster;
  p.threads = k.threads             ? k.threads
              : p.cluster > 1       ? 1024
              : blocks <= sms       ? 1024
              : blocks <= 2LL * sms ? 512
                                    : 256;
  p.active = dispatch(1, p.cluster, fit, p.stage, t, L, 0, p.threads, 0, st);
  std::memcpy(plan, &p, sizeof(p));
  if (p.live == 0) return 0;
  return dispatch(0, p.cluster, fit, p.stage, t, L, p.live, p.threads, skip, st);
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_tt_span_table_bytes() { return (int)sizeof(SpanTable); }

extern "C" int ccj_tt_span_plan_bytes() { return (int)sizeof(SpanPlan); }

extern "C" int ccj_tt_span_max_n2() { return kMaxN2; }

extern "C" int ccj_tt_span_max_jobs() { return kMaxJobs; }

// The whole tt loop of the span whose operands `table` (one SpanTable)
// holds, on `stream`, with the knobs of `knobs` (one SpanPlan; zeros and
// stage -1 for the plan's choices).  The plan: as many of the band's rows
// on chip as a block's shared memory holds (all of them up to about s =
// 140), the weights staged where they fit beside the whole band; from span
// kClusterSpan on, each live row and batch element gets a cluster of 4 or
// 2 blocks of 1024 threads where the card runs that many clusters at once
// (a span with few rows spreads each over more SMs), else one block: of
// 1024 threads where the blocks number at most the SMs, 512 up to twice
// that, else 256 (ttspan_variants.py measures each choice).  Writes what it
// launched to `plan` (a SpanPlan; live 0 when no row is live, and then
// nothing runs).  Returns the launch's error code: 0 on success.
extern "C" int ccj_tt_span(const void* table, const void* knobs, void* stream, void* plan) {
  return run(table, knobs, 0, stream, plan);
}

// Timing only: ccj_tt_span with the phases in `skip` left out of every
// step (1 the reductions, 2 the PM stencil, 4 the assembly; 7 leaves the
// empty steps, their barriers alone).  Its results are wrong; no fill
// calls it.
extern "C" int ccj_tt_span_phases(const void* table, const void* knobs, int skip, void* stream,
                                  void* plan) {
  if (skip < 0 || skip > 7) return (int)cudaErrorInvalidValue;
  return run(table, knobs, skip, stream, plan);
}
