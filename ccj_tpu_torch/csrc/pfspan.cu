// The partition function's span fill (ccj_tpu_torch/engine/pf4d.py), its
// four heavy parts as hand-written Hopper kernels (sm_90a), each with a
// float32 and a float64 instantiation:
//
//   pf_tt_span   the span's serial tt loop, every step in one launch;
//   pf_history   the span's 16 RL / RI weighted sums over earlier spans;
//   pf_stencil   the PL, PR and PO interior-loop sums over d1, d2 in [1, DS];
//   pf_p_split   P2's span-s diagonal over the PKE / PKD skews.
//
// What they replace.  The JAX package runs a span of its sum-product fill
// as one jitted XLA program (ccj_tpu/engine/pf4d.py:652-660, pf_span_step),
// with no Pallas kernel of its own.  Its tt loop (pf4d.py:470-579, t_body)
// computes six k-shrink and seven j-shrink sums a step,
//   out[i, j] = sum_{tp > tt} slab[tp, i, j] * w[tp, j],
// which is the function of the repo's one TPU kernel,
// ccj_tpu/engine/pallas_ops.py:38 (_minplus_kernel, launched at :70), in
// the (+, x) semiring; pf_tt_span is that kernel's counterpart on the PF
// path, with the rest of the step (the PM interior stencil and the 14
// families' assembly) fused in.  pf_history replaces the XLA fusion of
// pf4d.py:312-344 and :428-443, pf_stencil that of :359-427 and
// pf_p_split that of :206-233.  The port ran all four as eager PyTorch
// (engine/pf_ops.py's *_ref functions, their plain versions).
//
// Every kernel computes only the span's valid cells (tt <= s - 2, i >= 1,
// j >= i, j + tt + 2 <= i + s, i + s <= n) into an output the caller
// zero-fills, and every cell's sum in a fixed order: two runs agree bit
// for bit.  Every weight and state value is >= 0, so another summation
// order than the plain version's changes a sum by at most about
// (terms) x eps relative, with no cancellation.  No atomics.
//
// Bounds.  At n = 64 the valid cells of a span number (n - s) x s(s-1)/2
// (at most ~19 k), so each kernel moves at most a few MB and does at most
// a few hundred MFLOP: its bytes and operations take microseconds at
// 3.35 TB/s and 67 (float32) / 34 (float64) TFLOP/s.  pf_tt_span is bound
// by neither: its s - 1 steps are a chain (step tt reads the rows above
// it), so a span costs s - 1 dependent rounds of a block's loads; the
// other three are small enough to be bound by their launch.  The design
// follows from that: simple, right kernels, one launch a span each,
// replacing ~6,000 eager launches a span of the plain versions (the n=64
// float32 fill launched 797,597 device operations in all).
//
// pf_tt_span.  Every read of step tt stays in row i (red_k's
// slab[tp, i, j], red_j's slab[tp, i, j + tt - tp], the PM stencil's
// PM[tt + d1 + d2, i, j - d1], the fixed-offset rows tt + 1 and tt + 2),
// so one block takes a live row and walks tt down, with a barrier between
// the phases of a step.  The row's 14 slabs live in the output itself
// (the wrapper's [14, TB + 2, IB, n2] zeros, L2-resident: 14 x 65 x 66
// values a row at n = 64 are ~240 KB in float32, over the 227 KB of shared
// memory), read back with plain coherent loads after __syncthreads; the
// B (u-skewed) slabs and STM of the plain loop are not materialised: a
// j-shrink reads the family's own slab at j' = j + tt - tp.  The weights
// come from the [n2, n2] tables in the kernel (k-shrink X[k, k + tp - tt
// - 1] with k = j + tt + 2; j-shrink X[j' + 1, j]).  A step is three
// phases: (1) the PM stencil's partial sums, Q threads a column each
// taking every Q-th d1 (Q = min(DS, threads / columns)); (2) their sum
// in q order and PM's row tt; (3) the other 13 families' row tt, one
// (family, column) a thread.
//
// pf_history, pf_stencil.  A block per (live row, tt, window) with lanes
// along j (coalesced reads of the state and, for PL / PO, of the weights);
// each lane sums its cell's terms in order.  pf_p_split.  A block per live
// row; its threads take the (a, c) pairs in turn, each summing over b, and
// a fixed tree reduces the block.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kDS = 29;              // gapped.DS: interior offsets 1..29
constexpr int kBases = 7;
constexpr int kHist = 16;
constexpr int kTtThreads = 256;
constexpr int kRowThreads = 64;      // pf_history / pf_stencil: lanes along j
constexpr int kSplitThreads = 256;

// engine/gapped4.LOOP_MATS order (the output's family axis)
enum { kPLm00, kPLm01, kPLm10, kPRm00, kPRm10, kPMm00, kPMm01, kPMm10, kPM,
       kPfromL, kPfromR, kPfromM, kPfromMp, kPK, kFamilies };
// cuda_ops.STEP_BASES order
enum { bPLm00, bPLm10, bPRm00, bPMm01, bPMm10, bPfromL, bPfromR };
// pf_ops.PF_TABLES order
enum { tWP, tWB, tWBP };

// Mirrored field for field by ccj_tpu_torch/engine/pf_ops.py.
struct PfTtTable {
  const void* wx[3];                  // WP, WB, WBPg [n2, n2]
  const void* pls;                    // PLs, PRs, POs [TB, IB, n2]
  const void* prs;
  const void* pos;
  const void* base[kBases];           // [TB, IB, n2]
  const void* dpm;                    // [DS, DS, T, U]
  const void* canp;                   // bool [n2, n2]
  const void* ptype;                  // int32 [n2, n2]
  const void* estp;                   // [n2, n2]
  const void* expbp;                  // scalars (expcp: [n2])
  const void* expap;
  const void* expcp;
  const void* exppb;
  void* out;                          // [14, TB + 2, IB, n2], zeros
  int n, s, TB, IB, T, lo, nlive, f64;
};

struct PfHistTable {
  const void* src[kHist];             // [T, S, n2, n2]: the family or its C copy
  const void* wx[3];
  void* out;                          // [16, TB, IB, n2], zeros
  int mode[kHist];                    // 0 RL, 1 RI
  int g1[kHist];
  int table[kHist];                   // index into wx
  int n, s, TB, IB, T, S, lo, nlive, f64;
};

struct PfStencilTable {
  const void* src[3];                 // PL, PR, PO [T, S, n2, n2]
  const void* w[3];                   // W4PL [DS, DS, n2, n2],
                                      // W4PR [DS, DS, n2 + T + 2, 2 n2],
                                      // W4POD [DS, DS, n2, n2]
  void* out;                          // [3, TB, IB, n2], zeros
  int n, s, TB, IB, T, S, lo, nlive, f64;
};

struct PfPSplitTable {
  const void* pke;                    // [T, S + T + 2, n2, n2]
  const void* pkd;                    // [T, S, n2, n2]
  void* out;                          // [n2], zeros
  int n, s, T, S, lo, nlive, f64;
};

// sum_{tp = tt + 1}^{hi} slab[tp] * X[k, k + tp - tt - 1] (k-shrink);
// `slab` points at the cell (row i, column j) of row tp = 0.
template <typename T>
__device__ __forceinline__ T red_k(const T* slab, long long rs, const T* X, int n2,
                                   int tt, int hi, int k) {
  hi = min(hi, n2 + tt - k);                  // the weight's column < n2
  const T* w = X + (long long)k * n2 + k - tt - 1;
  T acc = 0;
  for (int tp = tt + 1; tp <= hi; ++tp) acc += slab[tp * rs] * __ldg(w + tp);
  return acc;
}

// sum_{tp = tt + 1}^{hi} slab[tp, j + tt - tp] * X[j + tt - tp + 1, j]
// (j-shrink); `slab` points at (row i, column 0) of row tp = 0.
template <typename T>
__device__ __forceinline__ T red_j(const T* slab, long long rs, const T* X, int n2,
                                   int tt, int hi, int j) {
  hi = min(hi, j + tt);                       // j' = j + tt - tp >= 0
  T acc = 0;
  for (int tp = tt + 1; tp <= hi; ++tp) {
    const int jp = j + tt - tp;
    acc += slab[tp * rs + jp] * __ldg(X + (long long)(jp + 1) * n2 + j);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kTtThreads) pf_tt_span_kernel(const __grid_constant__ PfTtTable t) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* part = reinterpret_cast<T*>(smem);        // the PM stencil's partial sums
  const int i = t.lo + blockIdx.x;
  const int s = t.s, n2 = t.n + 2, U = n2 + t.T;
  const long long rs = (long long)t.IB * n2;   // a slab's tt-row stride
  const long long fs = (long long)(t.TB + 2) * rs;
  const long long row = (long long)i * n2;
  T* out = static_cast<T*>(t.out) + row;       // out[f * fs + tp * rs + j]
  const T* pls = static_cast<const T*>(t.pls) + row;
  const T* prs = static_cast<const T*>(t.prs) + row;
  const T* pos = static_cast<const T*>(t.pos) + row;
  const T* WP = static_cast<const T*>(t.wx[tWP]);
  const T* WB = static_cast<const T*>(t.wx[tWB]);
  const T* WBP = static_cast<const T*>(t.wx[tWBP]);
  const T* dpm = static_cast<const T*>(t.dpm);
  const unsigned char* canp = static_cast<const unsigned char*>(t.canp);
  const int* ptype = static_cast<const int*>(t.ptype);
  const T* estp = static_cast<const T*>(t.estp);
  const T bp = *static_cast<const T*>(t.expbp);
  const T ap = *static_cast<const T*>(t.expap);
  const T cp1 = static_cast<const T*>(t.expcp)[1];
  const T PB = *static_cast<const T*>(t.exppb);
  const long long dpm_d = (long long)t.T * U;  // DPM's (d1, d2) stride

  for (int tt = s - 2; tt >= 0; --tt) {
    const int nj = s - tt - 1;                 // valid j = i + jr, jr in [0, nj)
    const int Q = nj >= kTtThreads ? 1 : min(kDS, kTtThreads / nj);
    const long long r0 = (long long)tt * rs;

    // (1) PM[tt, i, j] stencil: sum PM[tt + d1 + d2, i, j - d1] *
    //     DPM[d1, d2, tt, j + tt], d1 <= j - i - 1, d2 <= i + s - j - tt - 3
    for (int task = threadIdx.x; task < nj * Q; task += kTtThreads) {
      const int jr = task % nj, q = task / nj;
      const int d1max = min(kDS, jr - 1), d2max = min(kDS, s - tt - jr - 3);
      const T* pm = out + kPM * fs + (i + jr);
      const T* w = dpm + (long long)tt * U + (i + jr + tt);
      T acc = 0;
      for (int d1 = 1 + q; d1 <= d1max; d1 += Q) {
        const T* pmd = pm + (long long)(tt + d1) * rs - d1;
        const T* wd = w + (long long)(d1 - 1) * kDS * dpm_d;
        for (int d2 = 1; d2 <= d2max; ++d2)
          acc += pmd[d2 * rs] * __ldg(wd + (d2 - 1) * dpm_d);
      }
      part[task] = acc;
    }
    __syncthreads();

    // (2) PM's row tt
    for (int jr = threadIdx.x; jr < nj; jr += kTtThreads) {
      T pm_int = 0;
      for (int q = 0; q < Q; ++q) pm_int += part[q * nj + jr];
      const int j = i + jr, k = j + tt + 2;
      const long long c2 = (long long)(tt + 2) * rs + j - 1;   // row tt + 2, column j - 1
      const T pm_stack = out[kPM * fs + c2] * __ldg(estp + (long long)(j - 1) * n2 + k + 1);
      const T iloop = canp[(long long)j * n2 + k] ? pm_stack + pm_int : T(0);
      const T ml = (out[kPMm10 * fs + c2] + out[kPMm01 * fs + c2]) * ap * bp * bp;
      const T b3 = out[kPfromM * fs + c2];
      const T b4 = (jr == 0 && tt == s - 2) ? T(1) : T(0);      // i == j, i + s == k
      out[kPM * fs + r0 + j] = ptype[(long long)j * n2 + k] > 0 ? iloop + ml + b3 + b4 : T(0);
    }
    __syncthreads();

    // (3) the other 13 families' row tt
    for (int task = threadIdx.x; task < (kFamilies - 1) * nj; task += kTtThreads) {
      const int g = task / nj, jr = task % nj;
      const int f = g < kPM ? g : g + 1;
      const int j = i + jr, k = j + tt + 2;
      const long long c = r0 + j;
      const int hi = s - 2, hi_k1 = s - 3 - jr, hi_j1 = jr + tt - 1;
      const T PLs = pls[c], PRs = prs[c], POs = pos[c];
      const T PMs = out[kPM * fs + c];
#define PF_BASE(b) (static_cast<const T*>(t.base[b])[row + c])
#define PF_SLAB(fam) (out + (long long)(fam) * fs)
      T v;
      switch (f) {
        case kPLm00:
          v = PLs * bp + PF_BASE(bPLm00) + red_j(PF_SLAB(kPLm00), rs, WB, n2, tt, hi, j);
          break;
        case kPLm01:
          v = red_j(PF_SLAB(kPLm00), rs, WBP, n2, tt, hi, j);
          break;
        case kPLm10:
          v = PF_BASE(bPLm10) + red_j(PF_SLAB(kPLm10), rs, WB, n2, tt, min(hi, hi_j1), j);
          break;
        case kPRm00:
          v = PRs * bp + PF_BASE(bPRm00) + red_k(PF_SLAB(kPRm00) + j, rs, WB, n2, tt, hi, k);
          break;
        case kPRm10:
          v = out[kPRm10 * fs + c + rs] * cp1 +
              red_k(PF_SLAB(kPRm00) + j, rs, WBP, n2, tt, hi, k);
          break;
        case kPMm00:
          v = PMs * bp + red_j(PF_SLAB(kPMm00), rs, WB, n2, tt, hi, j) +
              red_k(PF_SLAB(kPMm00) + j, rs, WB, n2, tt, hi, k);
          break;
        case kPMm01:
          v = out[kPMm01 * fs + c + rs] * cp1 + PF_BASE(bPMm01);
          break;
        case kPMm10:
          v = out[kPMm10 * fs + c + rs - 1] * cp1 + PF_BASE(bPMm10);
          break;
        case kPfromL:
          v = PF_BASE(bPfromL) + red_j(PF_SLAB(kPfromL), rs, WP, n2, tt, min(hi, hi_j1), j) +
              (PRs + PMs + POs) * PB;
          break;
        case kPfromR:
          v = PF_BASE(bPfromR) + red_k(PF_SLAB(kPfromR) + j, rs, WP, n2, tt, min(hi, hi_k1), k) +
              (PMs + POs) * PB;
          break;
        case kPfromM:
          v = red_j(PF_SLAB(kPfromMp), rs, WP, n2, tt, min(hi, hi_j1), j);
          break;
        case kPfromMp: {                       // k-shrink of (PLs + PRs) * PB
          const int h = min(min(hi, hi_k1), n2 + tt - k);
          const T* w = WP + (long long)k * n2 + k - tt - 1;
          T acc = 0;
          for (int tp = tt + 1; tp <= h; ++tp)
            acc += (pls[tp * rs + j] + prs[tp * rs + j]) * PB * __ldg(w + tp);
          v = acc;
          break;
        }
        default:                               // kPK
          v = red_j(PF_SLAB(kPK), rs, WP, n2, tt, min(hi, hi_j1), j) +
              red_k(PF_SLAB(kPK) + j, rs, WP, n2, tt, min(hi, hi_k1), k) +
              (PLs + PMs + PRs + POs) * PB;
          break;
      }
#undef PF_BASE
#undef PF_SLAB
      out[(long long)f * fs + c] = v;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads) pf_history_kernel(const __grid_constant__ PfHistTable t) {
  const int i = t.lo + blockIdx.x, tt = blockIdx.y, w = blockIdx.z;
  const int s = t.s, n2 = t.n + 2;
  const int nj = s - tt - 1;
  const int sp0 = max(s - t.TB, 0);
  const bool ri = t.mode[w] != 0;
  const long long sps = (long long)n2 * n2;   // the state's span stride
  const T* X = static_cast<const T*>(t.wx[t.table[w]]);
  // RL: st[tt, sp, i, j] with X[i + sp + 1, i + s];
  // RI: C[tt, sp, i + s, j] with X[i, i + s - sp - 1]
  const T* src = static_cast<const T*>(t.src[w]) + (long long)tt * t.S * sps +
                 (long long)(ri ? i + s : i) * n2;
  T* out = static_cast<T*>(t.out) + (((long long)w * t.TB + tt) * t.IB + i) * n2;
  for (int jr = threadIdx.x; jr < nj; jr += kRowThreads) {
    const int j = i + jr;
    int lo = sp0;
    if (t.g1[w]) lo = max(lo, ri ? s - jr + 1 : jr + tt + 3);   // d = s - sp strict bound
    T acc = 0;
    for (int sp = lo; sp < s; ++sp) {
      const T wv = ri ? __ldg(X + (long long)i * n2 + (i + s - sp - 1))
                      : __ldg(X + (long long)(i + sp + 1) * n2 + (i + s));
      acc += __ldg(src + sp * sps + j) * wv;
    }
    out[j] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads) pf_stencil_kernel(const __grid_constant__ PfStencilTable t) {
  const int i = t.lo + blockIdx.x, tt = blockIdx.y, kind = blockIdx.z;
  const int s = t.s, n2 = t.n + 2, T_ = t.T;
  const int nj = s - tt - 1;
  const long long nn = (long long)n2 * n2;
  const long long tts = (long long)t.S * nn;  // the state's tt stride
  const T* src = static_cast<const T*>(t.src[kind]);
  const T* W = static_cast<const T*>(t.w[kind]);
  T* out = static_cast<T*>(t.out) + (((long long)kind * t.TB + tt) * t.IB + i) * n2;
  for (int jr = threadIdx.x; jr < nj; jr += kRowThreads) {
    const int j = i + jr;
    T acc = 0;
    if (kind == 0) {
      // PL[tt + d2, s - d1, i + d1, j - d2] * W4PL[d1, d2, i, j]
      const int d1m = min(min(kDS, s), n2 - 1 - i), d2m = min(min(kDS, T_ - 1 - tt), j);
      for (int d1 = 1; d1 <= d1m; ++d1) {
        const T* x = src + (long long)tt * tts + (long long)(s - d1) * nn + (long long)(i + d1) * n2 + j;
        const T* wd = W + (long long)(d1 - 1) * kDS * nn + (long long)i * n2 + j;
        for (int d2 = 1; d2 <= d2m; ++d2)
          acc += __ldg(x + d2 * tts - d2) * __ldg(wd + (d2 - 1) * nn);
      }
    } else if (kind == 1) {
      // PR[tt + d1, s - d2, i, j] * W4PR[d1, d2, j + tt + 2, s + i]
      const int KP = n2 + T_ + 2, LP = 2 * n2;
      const long long wkl = (long long)KP * LP;
      const int d1m = min(kDS, T_ - 1 - tt), d2m = min(kDS, s);
      for (int d1 = 1; d1 <= d1m; ++d1) {
        const T* x = src + (long long)(tt + d1) * tts + (long long)s * nn + (long long)i * n2 + j;
        const T* wd = W + (long long)(d1 - 1) * kDS * wkl + (long long)(j + tt + 2) * LP + s + i;
        for (int d2 = 1; d2 <= d2m; ++d2)
          acc += __ldg(x - d2 * nn) * __ldg(wd + (d2 - 1) * wkl);
      }
    } else {
      // PO[tt, s - d1 - d2, i + d1, j] * W4POD[d1, d2, i, s],
      // d1 <= j - i - 1, d2 <= i + s - j - tt - 3
      const int d1m = min(kDS, jr - 1), d2m = min(kDS, s - tt - jr - 3);
      for (int d1 = 1; d1 <= d1m; ++d1) {
        const T* x = src + (long long)tt * tts + (long long)(s - d1) * nn + (long long)(i + d1) * n2 + j;
        const T* wd = W + (long long)(d1 - 1) * kDS * nn + (long long)i * n2 + s;
        for (int d2 = 1; d2 <= d2m; ++d2)
          acc += __ldg(x - d2 * nn) * __ldg(wd + (d2 - 1) * nn);
      }
    }
    out[j] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSplitThreads) pf_p_split_kernel(const __grid_constant__ PfPSplitTable t) {
  __shared__ T red[kSplitThreads];
  const int i = t.lo + blockIdx.x;
  const int s = t.s, n2 = t.n + 2;
  const long long nn = (long long)n2 * n2;
  const long long e0 = (long long)(t.S + t.T + 2) * nn;   // PKE's b stride
  const long long d0 = (long long)t.S * nn;              // PKD's c stride
  const T* pke = static_cast<const T*>(t.pke);
  const T* pkd = static_cast<const T*>(t.pkd);
  // the (a, c) pairs a <= s - 3, c <= s - 3 - a in order, every
  // kSplitThreads-th one from this thread's
  T acc = 0;
  int a = 0, c = threadIdx.x;
  for (;;) {
    while (a <= s - 3 && c > s - 3 - a) { c -= s - 2 - a; ++a; }
    if (a > s - 3) break;
    // sum_b PKE[b, a + c + 2, i, a] * PKD[c, s - a - 1, i + a + 1, b]
    const T* e = pke + (long long)(a + c + 2) * nn + (long long)i * n2 + a;
    const T* d = pkd + c * d0 + (long long)(s - a - 1) * nn + (long long)(i + a + 1) * n2;
    const int nb = s - 2 - a - c;
    for (int b = 0; b < nb; ++b) acc += __ldg(e + b * e0) * __ldg(d + b);
    c += kSplitThreads;
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kSplitThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) static_cast<T*>(t.out)[i] = red[0];
}

template <typename Table>
bool load(Table* t, const void* table) {
  std::memcpy(t, table, sizeof(Table));
  return t->nlive >= 1 && t->nlive <= 65535 && t->s >= 2 && t->lo >= 1;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns
// cudaGetLastError() after its launch: 0 on success.

extern "C" int ccj_pf_table_bytes(int which) {
  switch (which) {
    case 0: return (int)sizeof(PfTtTable);
    case 1: return (int)sizeof(PfHistTable);
    case 2: return (int)sizeof(PfStencilTable);
    case 3: return (int)sizeof(PfPSplitTable);
    default: return -1;
  }
}

extern "C" int ccj_pf_ds() { return kDS; }

extern "C" int ccj_pf_tt_span(const void* table, void* stream) {
  PfTtTable t;
  if (!load(&t, table) || t.TB < t.s - 1 || t.IB < t.lo + t.nlive) return (int)cudaErrorInvalidValue;
  const int parts = t.s > kTtThreads ? t.s : kTtThreads;
  const size_t smem = (size_t)parts * (t.f64 ? sizeof(double) : sizeof(float));
  if (t.f64)
    pf_tt_span_kernel<double><<<t.nlive, kTtThreads, smem, (cudaStream_t)stream>>>(t);
  else
    pf_tt_span_kernel<float><<<t.nlive, kTtThreads, smem, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

extern "C" int ccj_pf_history(const void* table, void* stream) {
  PfHistTable t;
  if (!load(&t, table) || t.TB < t.s - 1 || t.IB < t.lo + t.nlive) return (int)cudaErrorInvalidValue;
  const dim3 grid(t.nlive, t.s - 1, kHist);
  if (t.f64)
    pf_history_kernel<double><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(t);
  else
    pf_history_kernel<float><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

extern "C" int ccj_pf_stencil(const void* table, void* stream) {
  PfStencilTable t;
  if (!load(&t, table) || t.TB < t.s - 1 || t.IB < t.lo + t.nlive) return (int)cudaErrorInvalidValue;
  const dim3 grid(t.nlive, t.s - 1, 3);
  if (t.f64)
    pf_stencil_kernel<double><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(t);
  else
    pf_stencil_kernel<float><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

extern "C" int ccj_pf_p_split(const void* table, void* stream) {
  PfPSplitTable t;
  if (!load(&t, table) || t.s < 3) return (int)cudaErrorInvalidValue;
  if (t.f64)
    pf_p_split_kernel<double><<<t.nlive, kSplitThreads, 0, (cudaStream_t)stream>>>(t);
  else
    pf_p_split_kernel<float><<<t.nlive, kSplitThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
