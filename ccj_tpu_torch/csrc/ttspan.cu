// tt_span: a whole span's serial tt loop in one launch, hand-written for
// Hopper (sm_90a).  For span s it runs tt = s - 2 down to 0, and each step
// computes what minplus_group (csrc/minplus.cu) and tt_step (csrc/ttstep.cu)
// compute in their two launches per step:
//
//   - the step's 13 k-shrink / j-shrink min-plus reductions
//     (ttloop.REDUCTIONS), each
//       red[g][j] = min(INF, min over admissible q of slab[tt + 1 + q, r, col] + w[q, wcol])
//     with red_k reading an A slab at column j and weight column tt + 2 + j
//     under q <= s - 4 - tt - j + i (masked), and red_j reading the
//     u-skewed B slab at column tt + j under q <= j - i - 2 (masked);
//   - the assembly of the 14 families' row tt, the PM interior stencil at
//     u = j + tt and the store encoding enc(v) = valid ? clamp(v, -32768,
//     SAT16) : INF, exactly as tt_step; then the write-back of row tt.
//
// Every read of step tt is of the step's own (b, r) row (the windows carry
// no i offset, the stencil and the previous rows read row r, the bases and
// PL / PR / PO read (tt, r, j), the jk rows and DPM are the same for every
// row), so one block per (b, r) row, or one thread-block cluster, runs all
// s - 1 steps with a barrier between steps.  Rows never wait on each other:
// no grid-wide sync, no cooperative launch, any grid.
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
// What stays on chip, and what no longer exists:
//   1. One launch per span instead of 2 (s - 1): the host's ctypes launch
//      path, which set the pace of the two-launch loop at n <= 100, runs
//      once per span.
//   2. A step's 13 x n2 reduction results go to shared memory (red), not to
//      a red_out in device memory; partial minima meet there by atomicMin
//      (min over int32 is exact and order-free, so any split of the terms
//      gives bit-identical results).
//   3. The PM stencil reads STM[tt + d1 + d2, r, u + d2], which is row
//      x = tt + d1 + d2 of PM itself at column j - d1 (STM row x holds PM's
//      row x at columns [x, x + n2), INF elsewhere, and the stencil's bounds
//      give d1 + d2 <= s - 4 - tt and 1 <= j - d1).  The block keeps PM's
//      last kRing rows in a shared-memory ring, written as each step
//      computes them: STM is neither allocated nor read.
//   4. The B slabs (the u-skewed copies of six families) are not kept
//      either: B[x, r, tt + j] = A[x, r, j - 1 - q] for x = tt + 1 + q
//      <= s - 2 and 0 <= j - 1 - q, else INF, so red_j reads the A slab and
//      skips the INF terms.  A skipped term is INF + w with |w| small: it
//      can only move a reduction that no finite term reached, among values
//      above SAT16 that enc maps to SAT16 (or INF) alike, so every stored
//      row is bit-equal to the plain loop's.
//   5. The stencil is split over the block: a task is one (j tile, d2), its
//      lanes walk d1 for 32 neighbouring cells, so their STM reads (shared
//      memory) and DPM reads (device memory, served from L2 to every row's
//      block) are on neighbouring addresses.  The reductions' tasks are
//      (job, j tile, chunk of kQChunk q): j along lanes, q split over
//      warps, as in minplus.cu.
//   6. Launch plan (ccj_tt_span): a span with few rows spreads each over a
//      cluster of 2 or 4 blocks, as many as the card's SMs hold at once;
//      with one block per SM or fewer a block takes 1024 threads, else
//      512 so that two share an SM.  Each choice was the fastest at the
//      spans chip_smoke.py times (ccj_tpu_torch/ttspan_variants.py holds the
//      alternatives).
//
// Coherence.  Slabs the launch writes (the 14 A slabs) are never read
// through __ldg or a const __restrict__ pointer: with one block per row a
// plain load after __syncthreads() sees the block's own writes; in a
// cluster (kC > 1 blocks per row, on different SMs) a block reads a row
// another block wrote only after cluster.sync() and with __ldcg (L2, not
// L1), and the reductions' partial minima and the PM ring travel through
// distributed shared memory.  Only the operands no one writes (mdp, the
// weights, the bases, PL / PR / PO, jk, valid, DPM) take the read-only path.
//
// Bound.  chip_smoke.py's span_bound: the span's loop as one function,
// each input element that some step needs read once (the slab rows >= s - 1
// and mdp at the terms that use them, the weights, DPM at the stencil
// terms, the bases, PL / PR / PO, jk and valid at the valid cells) and rows
// [0, s - 2] of the 14 families written once, over the 3.35 TB/s memory
// rate (bytes bound it; the adds and mins are a fraction of the int32
// rate).  Its two_kernel_bound, the yardstick of the two-launch loop this
// kernel replaces, is the sum over the span's steps of the two per-step
// kernels' bounds (group_bound + step_bound): every step's reads once per
// step, and the reductions, the B slab rows and STM written every step.
// The design keeps those last three on chip and meets each row's own
// earlier rows again in L1 / L2, not in device memory; what is left between
// it and span_bound: each row's block re-reads its slab window and the
// weights at every step (a row's working set, 9 slabs x (s + TB) rows x n2
// and the weights, is far beyond shared memory, and no other row shares
// its slab loads), which makes the reductions most of the kernel's time; a
// step is a latency chain of two barriers whose work per block is small at
// narrow rows; and a cluster buys SMs for a span with few rows at the cost
// of DSMEM traffic and cluster barriers.
//
// Limits: n2 <= kMaxN2 (shared memory: (14 + kRing) x n2 int32 per block,
// 160 KB at kMaxN2), at most kMaxJobs descriptors, batch <= 65535 (grid.y).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

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
constexpr int kRing = 64;               // PM rows tt + 2 .. tt + 2 DS live at once
constexpr int kQChunk = 32;             // q values of one reduction task
constexpr int kUnroll = 4;              // its slab loads in flight per lane
static_assert(kRing > 2 * kDS && (kRing & (kRing - 1)) == 0, "ring rows");

enum Family {
  PLmloop00, PLmloop01, PLmloop10, PRmloop00, PRmloop10, PMmloop00,
  PMmloop01, PMmloop10, PM, PfromL, PfromR, PfromM, PfromMprime, PK
};
enum Base { bPLmloop00, bPLmloop10, bPRmloop00, bPMmloop01, bPMmloop10, bPfromL, bPfromR };

// One operand: base pointer and element strides over (batch, row, i, j).
// Mirrored by ccj_tpu_torch/engine/cuda_ops.py:Plane.
struct Plane {
  void* p;
  long long s[4];
};

// One reduction descriptor, mirrored by cuda_ops.py:SpanJob.  kind 0 is
// red_k (A slab `src`, rows tt + 1 + q, column j; weight column tt + 2 + j),
// kind 1 is red_j (A slab `src` at column j - 1 - q, rows <= s - 2; weight
// column j).  A second weight table w2 (-1: none) on the same slab window
// feeds a second output.
struct Job {
  int src;                    // family index; kFamilies is mdp
  int kind, masked;
  int w, out, w2, out2;
};

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py:SpanTable.
struct SpanTable {
  Plane cur[kFamilies];       // A slabs [B, R, IB, n2]
  Plane mdp;                  // [B, R, IB, n2], read only
  Plane wt[kWeights];         // [B, Q, cols] (i stride 0)
  Plane base[kBases];         // [B, T, IB, n2], read at row tt
  Plane jk[3];                // canp, ptype, ESTP rows [B, T, n2] (i stride 0)
  Plane valid;                // bool [T, IB, n2] (batch stride 0)
  Plane pl, pr, po;           // [B, T, IB, n2]
  const int* dpm;             // [B, DS, DS, T, U]
  long long dpm_s[5];
  Job jobs[kMaxJobs];
  int njobs, B, s, i0, IB, n2, Q, bp, cp, ap, PB, SAT16, INF;
};

__device__ __forceinline__ long long off(const Plane& P, long long b, long long row,
                                         long long i, long long j) {
  return b * P.s[0] + row * P.s[1] + i * P.s[2] + j * P.s[3];
}

// A read-only operand.
__device__ __forceinline__ int ldro(const Plane& P, long long b, long long row, int i, int j) {
  return __ldg(static_cast<const int*>(P.p) + off(P, b, row, i, j));
}

// A weight the reductions or the stencil read (WKX, WJX, DPM): read only.
__device__ __forceinline__ int ldw(const int* p) { return __ldg(p); }

// A slab the launch writes: a plain load within one block (L1 sees the
// block's own stores), an L2 load across a cluster.
template <int kC>
__device__ __forceinline__ int ldslab(const int* p) {
  if constexpr (kC > 1) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

template <int kC>
__device__ __forceinline__ void span_sync() {
  if constexpr (kC > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// p in the shared memory of the cluster's block `rank` (this block's own
// for kC = 1).
template <int kC>
__device__ __forceinline__ int* at_rank(int* p, int rank) {
  if constexpr (kC > 1) {
    return cg::this_cluster().map_shared_rank(p, rank);
  } else {
    return p;
  }
}

__device__ __forceinline__ int min3(int a, int b, int c) { return min(min(a, b), c); }

// One reduction task: lanes j = jt * 32 + lane, q in [q0, q1] of job d, into
// the partial minima of red[d.out] (and red[d.out2]) held by the block that
// owns j tile jt.  kKind: 0 red_k, 1 red_j; kW: 1 or 2 weight tables.
template <int kC, int kKind, int kW>
__device__ __forceinline__ void reduce_task(const SpanTable& t, const Job& d, int* red, int n2p,
                                            long long b, int r, int i, int tt, int jt, int q0,
                                            int q1) {
  const int INF = t.INF;
  const int lane = threadIdx.x & 31;
  const int j = jt * 32 + lane;
  int hi = j < t.n2 ? q1 : -1;
  if (kKind == 0) {
    if (d.masked) hi = min(hi, t.s - 4 - tt - j + i);
  } else {
    hi = min(hi, min(j - 1, t.s - 3 - tt));
    if (d.masked) hi = min(hi, j - i - 2);
  }
  const int qmax = __reduce_max_sync(0xffffffffu, hi);
  if (qmax < q0) return;
  const Plane& S = d.src < kFamilies ? t.cur[d.src] : t.mdp;
  const Plane& W = t.wt[d.w];
  const Plane& W2 = t.wt[kW == 2 ? d.w2 : d.w];
  const int jc = min(j, t.n2 - 1);                 // pointers of idle lanes stay inside
  // slab element of q = q0 and its step per q
  const int* sp = static_cast<const int*>(S.p) + b * S.s[0] + (long long)r * S.s[2] +
                  (long long)(tt + 1 + q0) * S.s[1] +
                  (long long)(kKind == 0 ? jc : max(jc - 1 - q0, 0)) * S.s[3];
  const long long sstep = kKind == 0 ? S.s[1] : S.s[1] - S.s[3];
  const int wcol = kKind == 0 ? tt + 2 + jc : jc;
  const int* wp = static_cast<const int*>(W.p) + b * W.s[0] + (long long)q0 * W.s[1] +
                  (long long)wcol * W.s[3];
  const int* wp2 = static_cast<const int*>(W2.p) + b * W2.s[0] + (long long)q0 * W2.s[1] +
                   (long long)wcol * W2.s[3];
  int acc = INF, acc2 = INF;
  int q = q0;
  for (; q + kUnroll - 1 <= qmax; q += kUnroll) {
    int v[kUnroll], w[kUnroll], w2[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = q + u <= hi;
      v[u] = ok ? ldslab<kC>(sp + u * sstep) : INF;
      w[u] = ok ? ldw(wp + u * W.s[1]) : 0;
      if (kW == 2) w2[u] = ok ? ldw(wp2 + u * W2.s[1]) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = min(acc, v[u] + w[u]);
      if (kW == 2) acc2 = min(acc2, v[u] + w2[u]);
    }
    sp += kUnroll * sstep;
    wp += kUnroll * W.s[1];
    wp2 += kUnroll * W2.s[1];
  }
  for (; q <= qmax; ++q) {
    if (q <= hi) {
      const int v = ldslab<kC>(sp);
      acc = min(acc, v + ldw(wp));
      if (kW == 2) acc2 = min(acc2, v + ldw(wp2));
    }
    sp += sstep;
    wp += W.s[1];
    wp2 += W2.s[1];
  }
  if (j < t.n2) {
    int* own = at_rank<kC>(red, jt % kC);
    if (acc < INF) atomicMin(own + d.out * n2p + j, acc);
    if (kW == 2 && acc2 < INF) atomicMin(own + d.out2 * n2p + j, acc2);
  }
}

// One stencil task: the d2 column of the PM interior stencil for the 32
// cells of j tile jt, each lane walking its admissible d1; the partial
// minimum goes to pmacc of the block that owns jt.
template <int kC>
__device__ __forceinline__ void stencil_task(const SpanTable& t, const int* ring, int* pmacc,
                                             int n2p, long long b, int i, int tt, int jt,
                                             int d2) {
  const int lane = threadIdx.x & 31;
  const int j = jt * 32 + lane;
  const int d1max = j < t.n2 ? min(kDS, j - i - 1) : 0;
  const int d2max = min(kDS, i + t.s - j - tt - 3);
  const bool ok = d1max >= 1 && d2 <= d2max;
  if (!__any_sync(0xffffffffu, ok) || !ok) return;
  const int* dp = t.dpm + b * t.dpm_s[0] + (long long)(d2 - 1) * t.dpm_s[2] +
                  (long long)tt * t.dpm_s[3] + (long long)(j + tt) * t.dpm_s[4];
  int acc = t.INF;
#pragma unroll 4
  for (int d1 = 1; d1 <= d1max; ++d1) {
    acc = min(acc, ring[((tt + d1 + d2) & (kRing - 1)) * n2p + j - d1] +
                       ldw(dp + (long long)(d1 - 1) * t.dpm_s[1]));
  }
  if (acc < t.INF) atomicMin(at_rank<kC>(pmacc, jt % kC) + j, acc);
}

template <int kC, int kThreads>
__global__ void __launch_bounds__(kThreads)
tt_span_kernel(const __grid_constant__ SpanTable t) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ int smem[];
  const int n2 = t.n2;
  const int n2p = (n2 + 31) & ~31;
  int* red = smem;                                 // [13][n2p] partial minima
  int* pmacc = red + kReductions * n2p;            // [n2p] stencil partial minima
  int* ring = pmacc + n2p;                         // [kRing][n2p] PM rows, own columns
  const int rank = kC > 1 ? (int)(blockIdx.x % kC) : 0;
  const int r = blockIdx.x / kC;
  const long long b = blockIdx.y;
  const int i = t.i0 + r;
  const int INF = t.INF;
  const int warp = threadIdx.x >> 5;
  const int gw = rank * kWarps + warp;             // the warp's index in its row
  constexpr int kRowWarps = kC * kWarps;
  const int njt = (n2 + 31) >> 5;
  const int nqc = (t.Q + kQChunk - 1) / kQChunk;
  const int top = t.SAT16 + t.bp;

  for (int k = threadIdx.x; k < (kReductions + 1 + kRing) * n2p; k += kThreads) smem[k] = INF;
  span_sync<kC>();

  for (int tt = t.s - 2; tt >= 0; --tt) {
    // ---- the 13 reductions and the PM stencil, as independent tasks ----
    const int nred = t.njobs * njt * nqc;
    for (int task = gw; task < nred + njt * kDS; task += kRowWarps) {
      if (task < nred) {
        const int qc = task % nqc;
        const int jt = (task / nqc) % njt;
        const Job& d = t.jobs[task / (nqc * njt)];
        const int q0 = qc * kQChunk, q1 = min(q0 + kQChunk, t.Q) - 1;
        if (d.kind == 0) {
          if (d.w2 >= 0) {
            reduce_task<kC, 0, 2>(t, d, red, n2p, b, r, i, tt, jt, q0, q1);
          } else {
            reduce_task<kC, 0, 1>(t, d, red, n2p, b, r, i, tt, jt, q0, q1);
          }
        } else if (d.w2 >= 0) {
          reduce_task<kC, 1, 2>(t, d, red, n2p, b, r, i, tt, jt, q0, q1);
        } else {
          reduce_task<kC, 1, 1>(t, d, red, n2p, b, r, i, tt, jt, q0, q1);
        }
      } else {
        const int k = task - nred;
        stencil_task<kC>(t, ring, pmacc, n2p, b, i, tt, k % njt, k / njt + 1);
      }
    }
    span_sync<kC>();

    // ---- assembly and write-back of row tt at the columns this block owns
    for (int j = threadIdx.x; j < n2; j += kThreads) {
      if ((j >> 5) % kC != rank) continue;
      auto prev = [&](int f, int c, int dj) {
        return j + dj < 0 ? INF
                          : ldslab<kC>(static_cast<const int*>(t.cur[f].p) +
                                       off(t.cur[f], b, tt + c, r, j + dj));
      };
      auto base = [&](int k) { return ldro(t.base[k], b, tt, r, j); };
      auto rd = [&](int g) { return red[g * n2p + j]; };

      int out[kFamilies];
      out[PLmloop00] = min3(top, base(bPLmloop00), rd(0));
      out[PLmloop01] = rd(1);
      out[PLmloop10] = min(base(bPLmloop10), rd(2));
      out[PRmloop00] = min3(top, base(bPRmloop00), rd(3));
      out[PRmloop10] = min(prev(PRmloop10, 1, 0) + t.cp, rd(4));
      out[PMmloop00] = min3(top, rd(5), rd(6));
      out[PMmloop01] = min(prev(PMmloop01, 1, 0) + t.cp, base(bPMmloop01));
      out[PMmloop10] = min(prev(PMmloop10, 1, -1) + t.cp, base(bPMmloop10));

      const int pm_int = pmacc[j];
      const int canp = ldro(t.jk[0], b, tt, 0, j);
      const int pt = ldro(t.jk[1], b, tt, 0, j);
      const int estp = ldro(t.jk[2], b, tt, 0, j);
      const int pm_stack = prev(PM, 2, -1) + estp;
      const int pm_iloop = canp > 0 ? min(pm_stack, pm_int) : INF;
      const int pm_mloop = min(prev(PMmloop10, 2, -1), prev(PMmloop01, 2, -1)) + t.ap + t.bp;
      const int pm_b3 = prev(PfromM, 2, -1);
      const int pm_b4 = (i == j && tt == t.s - 2) ? 0 : INF;
      const int pmv = pt > 0 ? min(min3(pm_iloop, pm_mloop + t.bp, pm_b3), pm_b4) : INF;

      const bool valid = __ldg(static_cast<const unsigned char*>(t.valid.p) +
                               off(t.valid, 0, tt, r, j)) != 0;
      auto enc = [&](int v) { return valid ? min(max(v, -32768), t.SAT16) : INF; };
      const int pms = enc(pmv);
      const int pls = ldro(t.pl, b, tt, r, j) + t.PB;
      const int prs = ldro(t.pr, b, tt, r, j) + t.PB;
      const int pos = ldro(t.po, b, tt, r, j) + t.PB;
      out[PM] = pmv;
      out[PfromL] = min(min3(base(bPfromL), rd(7), prs), min(pms + t.PB, pos));
      out[PfromR] = min(min3(base(bPfromR), rd(8), pms + t.PB), pos);
      out[PfromM] = rd(9);
      out[PfromMprime] = rd(10);
      out[PK] = min(min3(rd(11), rd(12), pls), min3(pms + t.PB, prs, pos));

#pragma unroll
      for (int f = 0; f < kFamilies; ++f) {
        static_cast<int*>(t.cur[f].p)[off(t.cur[f], b, tt, r, j)] = f == PM ? pms : enc(out[f]);
      }
      // PM's row tt into every ring of the row's blocks; the partial
      // minima this block owns start the next step at INF
      const int slot = (tt & (kRing - 1)) * n2p + j;
#pragma unroll
      for (int c = 0; c < kC; ++c) at_rank<kC>(ring, c)[slot] = pms;
#pragma unroll
      for (int g = 0; g < kReductions; ++g) red[g * n2p + j] = INF;
      pmacc[j] = INF;
    }
    span_sync<kC>();
  }
}

template <int kC, int kThreads>
int launch(const SpanTable& t, cudaStream_t stream) {
  const int n2p = (t.n2 + 31) & ~31;
  const int smem = (kReductions + 1 + kRing) * n2p * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(tt_span_kernel<kC, kThreads>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(t.IB * kC, t.B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kC > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, tt_span_kernel<kC, kThreads>, t);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_tt_span_table_bytes() { return (int)sizeof(SpanTable); }

extern "C" int ccj_tt_span_max_n2() { return kMaxN2; }

extern "C" int ccj_tt_span_max_jobs() { return kMaxJobs; }

// The whole tt loop of the span whose operands `table` (one SpanTable)
// holds, on `stream`, with `cluster` blocks per row (1, 2 or 4; 0: the
// largest of them whose blocks, B x IB x cluster, the card's SMs hold at
// once, so a span with few rows spreads them over more SMs).  A block takes
// 1024 threads where the grid is one block per SM or fewer, else 512 (two
// blocks share an SM; chip_smoke.py's phase 2c and PERF.md hold the
// figures).  Writes the (cluster, threads) it launched to plan[0], plan[1].
// Returns the launch's error code: 0 on success.
extern "C" int ccj_tt_span(const void* table, int cluster, void* stream, int* plan) {
  SpanTable t;
  std::memcpy(&t, table, sizeof(t));
  if (t.B < 1 || t.B > 65535 || t.IB < 0 || t.n2 < 1 || t.n2 > kMaxN2 || t.s < 2 ||
      t.Q < 1 || t.njobs < 1 || t.njobs > kMaxJobs)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)t.IB * t.B;
  if (cluster == 0) {
    cluster = 1;
    for (int c = 2; c <= 4; c *= 2) {
      if (rows * c <= sms) cluster = c;
    }
  }
  const bool wide = rows * cluster <= sms;
  plan[0] = cluster;
  plan[1] = wide ? 1024 : 512;
  if (t.IB == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (cluster * (wide ? -1 : 1)) {
    case 1: return launch<1, 512>(t, st);
    case 2: return launch<2, 512>(t, st);
    case 4: return launch<4, 512>(t, st);
    case -1: return launch<1, 1024>(t, st);
    case -2: return launch<2, 1024>(t, st);
    case -4: return launch<4, 1024>(t, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
