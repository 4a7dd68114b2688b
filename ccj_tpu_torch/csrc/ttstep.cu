// tt_step: the serial tt loop's step after its 13 min-plus reductions, in
// one launch, hand-written for Hopper (sm_90a).  One thread per output cell
// (b, r, j): batch element b, slab row r (i = i0 + r), column j in [0, n2).
// From the step's reductions (red, written by minplus_group in the same
// step) and the span's operands it computes the 14 families' values at row
// tt, store-encodes them and writes them back:
//
//   - the min / where assembly of every family (the reduction planes, the
//     span-constant bases at row tt, the slabs' rows tt + 1 and tt + 2, the
//     latter at column j - 1 with INF at j = 0);
//   - PM: the interior stencil at the one column the step keeps, u = j + tt,
//
//       pm_int = min(INF, min over d1, d2 in [1, DS] of
//                    STM[b, tt + d1 + d2, r, u + d2] + DPM[b, d1 - 1, d2 - 1, tt, u])
//
//     under d1 <= (u - i - 1) - tt and d2 <= (i + s - u - 2) - 1, then the
//     stack, multiloop, PfromM and base cases (the base case is 0 where
//     i == j at tt = s - 2);
//   - enc(v) = valid[tt, r, j] ? clamp(v, -32768, SAT16) : INF on every
//     value, PM's before PfromL / PfromR / PK read it (+ PB);
//   - writes: row tt of every family's A slab (cur), columns [tt, tt + n2)
//     of row tt of each B slab and of STM.
//
// The step reads only rows > tt of the slabs and STM and writes row tt, so
// no cell reads what another cell of the same launch writes; stream order
// separates it from the next step's minplus_group, which reads row tt.
// All arithmetic is int32: INF = 10^7, so INF + INF + a weight never
// overflows, and every value is clamped only where the plain version
// clamps (enc, and pm_int's min with INF).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusion of
// the JAX loop body, ccj_tpu/engine/ttloop.py:436-551
// (run_tt_loop_unstacked.t_body after its red_k / red_j), which the port
// ran as ~200 eager PyTorch launches per step (ttloop.run_tt_loop before
// this kernel; its plain version is cuda_ops.tt_step_ref).
//
// Bound: bytes.  Per step the kernel must read the 13 reduction planes,
// the 7 base planes, 7 slab rows, the PL / PR / PO planes, the valid
// plane, 3 jk rows, the STM window (rows tt + 2 .. tt + 2 DS, IB rows,
// columns [tt + 1, tt + n2 + DS)) and DPM[:, :, :, tt, u] for u in
// [tt, tt + n2), and write 21 planes; at the main n = 100 step that is a
// few MB, about a microsecond at 3.35 TB/s.  Its operations (841 adds and
// mins per cell at most) are a fraction of that at the int32 rate.  This
// first version is simple and right, not fast: each thread walks its own
// cell's admissible (d1, d2) range with two loads per term (neighbouring
// threads read neighbouring u, so the loads coalesce, but a term of STM is
// read by up to DS cells), offsets are 64-bit, and at n = 100 one launch
// holds about 82 blocks of 128 threads, under one wave.  What it removes
// is the host's ~200 launches per step and the stencil's [B, DS, DS, IB,
// UB] temporary (67 MB at n = 100).

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kDS = 29;                 // gapped.DS: stencil offsets 1..29
constexpr int kThreads = 128;
constexpr int kReductions = 13;         // ttloop.REDUCTIONS
constexpr int kBases = 7;               // cuda_ops.STEP_BASES
constexpr int kFamilies = 14;           // cuda_ops.STEP_FAMILIES

// Family and base indices (cuda_ops.STEP_FAMILIES / STEP_BASES order).
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

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py:StepTable.
struct StepTable {
  Plane red;                  // [B, 13, IB, n2]
  Plane base[kBases];         // [B, T, IB, n2], read at row tt
  Plane cur[kFamilies];       // A slabs [B, R, IB, n2]
  Plane bslab[kFamilies];     // B slabs [B, R, IB, UB] (p null: none)
  Plane stm;                  // [B, R, IB, UB + DS]
  Plane jk[3];                // canp, ptype, ESTP rows [B, T, n2] (i stride 0)
  Plane valid;                // bool [T, IB, n2] (batch stride 0)
  Plane pl, pr, po;           // [B, T, IB, n2]
  const int* dpm;             // [B, DS, DS, T, U]
  long long dpm_s[5];
  int B, s, i0, IB, n2, bp, cp, ap, PB, SAT16, INF;
};

__device__ __forceinline__ long long off(const Plane& P, long long b, long long row,
                                         long long i, long long j) {
  return b * P.s[0] + row * P.s[1] + i * P.s[2] + j * P.s[3];
}

__device__ __forceinline__ int ld(const Plane& P, long long b, long long row, int i, int j) {
  return __ldg(static_cast<const int*>(P.p) + off(P, b, row, i, j));
}

__device__ __forceinline__ void st(const Plane& P, long long b, long long row, int i, int j,
                                   int v) {
  static_cast<int*>(P.p)[off(P, b, row, i, j)] = v;
}

__device__ __forceinline__ int min3(int a, int b, int c) { return min(min(a, b), c); }

__global__ void __launch_bounds__(kThreads)
tt_step_kernel(const __grid_constant__ StepTable t, int tt) {
  const int cell = blockIdx.x * kThreads + threadIdx.x;
  if (cell >= t.IB * t.n2) return;
  const int r = cell / t.n2;
  const int j = cell - r * t.n2;
  const long long b = blockIdx.y;
  const int i = t.i0 + r;
  const int INF = t.INF;
  const int top = t.SAT16 + t.bp;

  int red[kReductions];
#pragma unroll
  for (int g = 0; g < kReductions; ++g) red[g] = ld(t.red, b, g, r, j);
  // row tt + c of family f at column j + dj (INF left of column 0)
  auto prev = [&](int f, int c, int dj) {
    return j + dj < 0 ? INF : ld(t.cur[f], b, tt + c, r, j + dj);
  };
  auto base = [&](int k) { return ld(t.base[k], b, tt, r, j); };

  int out[kFamilies];
  out[PLmloop00] = min3(top, base(bPLmloop00), red[0]);
  out[PLmloop01] = red[1];
  out[PLmloop10] = min(base(bPLmloop10), red[2]);
  out[PRmloop00] = min3(top, base(bPRmloop00), red[3]);
  out[PRmloop10] = min(prev(PRmloop10, 1, 0) + t.cp, red[4]);
  out[PMmloop00] = min3(top, red[5], red[6]);
  out[PMmloop01] = min(prev(PMmloop01, 1, 0) + t.cp, base(bPMmloop01));
  out[PMmloop10] = min(prev(PMmloop10, 1, -1) + t.cp, base(bPMmloop10));

  // PM interior stencil at u = j + tt: only the admissible (d1, d2) terms
  // are visited (the masked ones are INF, which the min with INF absorbs)
  const int u = j + tt;
  const int d1max = min(kDS, (u - i - 1) - tt);
  const int d2max = min(kDS, (i + t.s - u - 2) - 1);
  int pm_int = INF;
  {
    const int* sp = static_cast<const int*>(t.stm.p) + b * t.stm.s[0] +
                    (long long)r * t.stm.s[2] + (long long)u * t.stm.s[3] +
                    (long long)tt * t.stm.s[1];
    const int* dp = t.dpm + b * t.dpm_s[0] + (long long)tt * t.dpm_s[3] +
                    (long long)u * t.dpm_s[4];
    for (int d2 = 1; d2 <= d2max; ++d2) {
      const int* srow = sp + (long long)d2 * (t.stm.s[1] + t.stm.s[3]);
      const int* drow = dp + (long long)(d2 - 1) * t.dpm_s[2];
#pragma unroll 4
      for (int d1 = 1; d1 <= d1max; ++d1) {
        pm_int = min(pm_int, __ldg(srow + (long long)d1 * t.stm.s[1]) +
                                 __ldg(drow + (long long)(d1 - 1) * t.dpm_s[1]));
      }
    }
  }

  const int canp = ld(t.jk[0], b, tt, 0, j);
  const int pt = ld(t.jk[1], b, tt, 0, j);
  const int estp = ld(t.jk[2], b, tt, 0, j);
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
  const int pls = ld(t.pl, b, tt, r, j) + t.PB;
  const int prs = ld(t.pr, b, tt, r, j) + t.PB;
  const int pos = ld(t.po, b, tt, r, j) + t.PB;
  out[PM] = pmv;
  out[PfromL] = min(min3(base(bPfromL), red[7], prs), min(pms + t.PB, pos));
  out[PfromR] = min(min3(base(bPfromR), red[8], pms + t.PB), pos);
  out[PfromM] = red[9];
  out[PfromMprime] = red[10];
  out[PK] = min(min3(red[11], red[12], pls), min3(pms + t.PB, prs, pos));

#pragma unroll
  for (int f = 0; f < kFamilies; ++f) {
    const int v = f == PM ? pms : enc(out[f]);
    st(t.cur[f], b, tt, r, j, v);
    if (t.bslab[f].p != nullptr) st(t.bslab[f], b, tt, r, u, v);
  }
  st(t.stm, b, tt, r, u, pms);
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_tt_step_table_bytes() { return (int)sizeof(StepTable); }

extern "C" int ccj_tt_step_ds() { return kDS; }

// Step tt of the span whose operands `table` (one StepTable) holds, on
// `stream`.  Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int ccj_tt_step(const void* table, int tt, void* stream) {
  StepTable t;
  std::memcpy(&t, table, sizeof(t));
  if (t.B < 1 || t.B > 65535 || t.IB < 0 || t.n2 < 0 || tt < 0 || tt > t.s - 2)
    return (int)cudaErrorInvalidValue;
  if (t.IB == 0 || t.n2 == 0) return 0;
  const dim3 grid((t.IB * t.n2 + kThreads - 1) / kThreads, t.B);
  tt_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(t, tt);
  return (int)cudaGetLastError();
}
