// The partition function's span body (ccj_tpu_torch/engine/pf4d.py,
// pf_span_step) around pfspan.cu's four kernels, as hand-written Hopper
// kernels (sm_90a), each with a float32 and a float64 instantiation:
//
//   pf_span2d    the span's 2-D recurrences: V (and its diagonal copy VD),
//                P2 (and PD) from pf_p_split's diagonal, WBP / WPP, the
//                kept weight tables' span-s cells, then WMv / WMp / WM;
//   pf_assemble  the 13 fixed-offset plane reads and the PL / PR / PO
//                assembly, the cross-span-only families and the PMmloop10
//                base of the tt loop;
//   pf_store     the write-back of the 22 families, the 5 C skews, PKD and
//                PKE.
//
// What they replace.  The JAX package runs a span of its sum-product fill
// as one jitted XLA program (ccj_tpu/engine/pf4d.py:654-660, pf_span_step)
// with no Pallas kernel of its own.  pf_span2d replaces the XLA fusion of
// pf_span_nested (:164-265, less its P split, which pf_p_split took) and
// pf_span_wm (:618-651), pf_assemble that of rplane_big_all (:297-310) with
// the assembly around the stencils (:371-443), pf_store that of the
// write-back (:581-615).  The port ran all three as eager PyTorch
// (engine/pf_ops.py's *_ref functions, their plain versions), about 600
// launches a span with _wx_pf's tables built twice.
//
// Order.  Row i of span s reads other rows only at spans below s
// (VD[s - dk - dl, i + dk], WM[i + 1, c - 1], WMv / WMp[c, i + s - 1],
// V / P2[dd, i + s] for dd > i, the kept tables' row-i cells at spans
// <= s - 2) and its own span-s cells only after it wrote them, so one
// launch holds the whole 2-D part, a block a row.  WM moves ahead of the
// gapped step: nothing of that step reads V, VD, P2, PD, WM, WMv or WMp,
// and the 2-D part reads nothing the step writes.  pf_store runs last, after
// every read of the state in the span.
//
// Bounds.  At n = 64 a span's 2-D part needs a few KB (at most 63 rows of
// <= 496 interior terms and ~4 s splits), so pf_span2d is bound by its
// launch; pf_assemble reads ~30 values a valid cell (a few MB a span) and
// pf_store writes 27 [TB, n2, n2] planes, PKD's and PKE's (~35 MB a span in
// float32): both bound by bytes, microseconds at 3.35 TB/s.  The design
// follows: simple kernels, right first, a block a row for the 2-D part and
// a thread a cell (a destination element for the store).  Validity is
// computed from (n, s, TB, IB): tt <= s - 2, i >= 1, j >= i,
// j + tt + 2 <= i + s, i + s <= n.  Sums run in a fixed order (a fixed
// tree over the block for pf_span2d's splits): two runs agree bit for
// bit; every weight and state value is >= 0, so the order changes a sum by
// at most about (terms) x eps relative.  No atomics.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kML = 30;              // io_par.MAXLOOP
constexpr int kTurn = 3;             // io_par.TURN
constexpr int kEint = kML + 2;       // EINTD's dk and dl extents
constexpr int k2dThreads = 128;      // pf_span2d: a block a row
constexpr int kWarps = k2dThreads / 32;
constexpr int kCellThreads = 256;    // pf_assemble, pf_store: a thread a cell
constexpr int kFamilies = 22;        // gapped.M4_NAMES
constexpr int kCMats = 5;            // gapped.C_MATS
constexpr int kReads = 13;           // pf_ops.PF_PLANE_READS
constexpr int kAssembled = 8;        // pf_ops.PF_ASSEMBLED and the PMmloop10 base

// pf_ops.PF_TABLES order
enum { tWP, tWB, tWBP };
// pf_ops.PF_SPAN2D_SCALARS order
enum { sScale2, sBp, sPPS, sPSM, sPSP, sB, kScalars };

// Mirrored field for field by ccj_tpu_torch/engine/pf_ops.py.
struct PfSpan2dTable {
  void* V;                            // [n2, n2]
  void* VD;                           // [S + 1, n2]
  void* P2;                           // [n2, n2]
  void* PD;                           // [S + 1, n2]
  void* WBP;                          // [n2, n2] (WPP, WM, WMv, WMp too)
  void* WPP;
  void* WM;
  void* WMv;
  void* WMp;
  void* wx[3];                        // the kept tables WP, WB, WBPg [n2, n2]
  const void* pnew;                   // [n2]: pf_p_split's P2(i, i + s)
  const void* hd;                     // [n2, n2]
  const void* eintd;                  // [ML + 2, ML + 2, n2, n2]
  const void* expmb;                  // [n2, n2]
  const void* expml;                  // [n2, n2]
  const void* expmlbase;              // [n2]
  const void* expcp;                  // [n2]
  const void* exppup;                 // [n2]
  const void* scalar[kScalars];       // scale2, expbp, expPPS, expPSM, expPSP, expb
  int n, s, S, f64;
};

struct PfAssembleTable {
  const void* plane[kReads];          // [T, S, n2, n2], PF_PLANE_READS order
  const void* hist;                   // [16, TB, IB, n2]: pf_history's sums
  const void* stn;                    // [3, TB, IB, n2]: pf_stencil's sums
  const void* estp;                   // [n2, n2]
  const void* canp;                   // bool [n2, n2]
  const void* ptype;                  // int32 [n2, n2]
  const void* expap;                  // scalars (expcp: [n2])
  const void* expbp;
  const void* expcp;
  const void* exppb;
  void* out;                          // [8, TB, IB, n2], every cell written
  int n, s, TB, IB, T, S, f64;
};

struct PfStoreTable {
  const void* src[kFamilies];         // each family's span slab, rows tt of
                                      // stride IB x n2 (M4_NAMES order)
  void* dst[kFamilies];               // the families [T, S, n2, n2]
  void* cdst[kCMats];                 // the C skews [T, S, n2, n2]
  int csrc[kCMats];                   // each C skew's family, an index into src
  void* pkd;                          // [T, S, n2, n2]
  void* pke;                          // [T, S + T + 2, n2, n2]
  int pk;                             // PK's index into src
  int n, s, TB, IB, T, S, f64;
};

// (c, b, di, dj) of the 13 plane reads: value[tt, i, j] =
// st[name][tt + c, s - b, i + di, j + dj], 0 off the array or where s < b.
// Mirrored by pf_ops.PF_PLANE_READS.
__device__ __forceinline__ int4 read_offsets(int r) {     // (c, b, di, dj)
  return r < 4 ? make_int4(1, 1, 1, -1) : r < 8 ? make_int4(1, 1, 0, 0)
                                         : r < 12 ? make_int4(0, 2, 1, 0) : make_int4(0, 1, 0, 0);
}
enum { rPL, rPLm10, rPLm01, rPfromL, rPR, rPRm10, rPRm01, rPfromR, rPO, rPOm10, rPOm01,
       rPfromO, rPRm01s0 };
// pf_ops.PF_HISTORY order (the sums pf_assemble reads)
enum { hRiPOm00, hRlPOm00, hPOm01, hRiPOm10, hRlPOm10, hRlPRm01, hRiPfromO, hRlPfromO,
       hRiPMm10 = 12, hRlPMm10 };

__device__ __forceinline__ bool valid_cell(int n, int s, int tt, int i, int j) {
  return i >= 1 && j >= i && j + tt + 2 <= i + s && i + s <= n;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Each of the N sums over the block, in a fixed tree: thread 0 gets them.
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&v)[N], T* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const T x = warp_sum(v[q]);
    if (lane == 0) sh[q * kWarps + warp] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      T x = sh[q * kWarps];
      for (int w = 1; w < kWarps; ++w) x += sh[q * kWarps + w];
      v[q] = x;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(k2dThreads) pf_span2d_kernel(const __grid_constant__ PfSpan2dTable t) {
  __shared__ T sh[4 * kWarps];
  __shared__ T own[2];                          // V(i, l) and P2(i, l) of this span
  const int i = blockIdx.x, s = t.s, n = t.n, n2 = n + 2, l = i + s;
  T* VD = static_cast<T*>(t.VD);
  T* PD = static_cast<T*>(t.PD);
  if (i < 1 || l > n) {                         // not a live row: 0 on the diagonals
    if (threadIdx.x == 0) {
      VD[(long long)s * n2 + i] = T(0);
      PD[(long long)s * n2 + i] = T(0);
    }
    return;
  }
  T* V = static_cast<T*>(t.V);
  T* P2 = static_cast<T*>(t.P2);
  T* WBP = static_cast<T*>(t.WBP);
  T* WPP = static_cast<T*>(t.WPP);
  T* WM = static_cast<T*>(t.WM);
  T* WMv = static_cast<T*>(t.WMv);
  T* WMp = static_cast<T*>(t.WMp);
  T* WP = static_cast<T*>(t.wx[tWP]);
  T* WB = static_cast<T*>(t.wx[tWB]);
  T* WBPg = static_cast<T*>(t.wx[tWBP]);
  const T* eintd = static_cast<const T*>(t.eintd);
  const T* expml = static_cast<const T*>(t.expml);
  const T* mlbase = static_cast<const T*>(t.expmlbase);
  const T* expcp = static_cast<const T*>(t.expcp);
  const T* exppup = static_cast<const T*>(t.exppup);
  T sc[kScalars];
#pragma unroll
  for (int q = 0; q < kScalars; ++q) sc[q] = *static_cast<const T*>(t.scalar[q]);
  const long long row = (long long)i * n2, il = row + l;

  // ---- V(i, l): the interior loops VD[s - dk - dl, i + dk] *
  //      EINTD[dk, dl, i, s] (dk <= min(s - 4, ML), dk + dl <= min(s - 4,
  //      ML + 2), i + dk <= n2 - 1), the multiloop splits c in
  //      [i + 1, l - 4]
  T acc[2] = {T(0), T(0)};
  const int dkmax = min(s - kTurn - 1, kML), m = min(s - kTurn - 1, kEint);
  for (int q = threadIdx.x; q < kEint * kEint; q += k2dThreads) {
    const int dk = q / kEint + 1, dl = q % kEint + 1;
    if (dk <= dkmax && dk + dl <= m && i + dk <= n2 - 1)
      acc[0] += __ldg(eintd + (((long long)dk * kEint + dl) * n2 + i) * n2 + s) *
                VD[(long long)(s - dk - dl) * n2 + i + dk];
  }
  for (int c = i + 1 + threadIdx.x; c <= l - kTurn - 1; c += k2dThreads) {
    const T wmp = WMp[(long long)c * n2 + l - 1];
    acc[1] += WM[row + n2 + c - 1] * (WMv[(long long)c * n2 + l - 1] + wmp) + __ldg(mlbase + c - i - 1) * wmp;
  }
  block_sum(acc, sh);
  if (threadIdx.x == 0) {
    const T v = __ldg(static_cast<const T*>(t.hd) + row + s) + acc[0] +
                acc[1] * __ldg(static_cast<const T*>(t.expmb) + il) * sc[sScale2];
    const T p = __ldg(static_cast<const T*>(t.pnew) + i);
    V[il] = v;
    VD[(long long)s * n2 + i] = v;
    P2[il] = p;
    PD[(long long)s * n2 + i] = p;
    own[0] = v;
    own[1] = p;
  }
  __syncthreads();

  // ---- WBP / WPP(i, l): the splits dd = i + g, g in [0, s - 1], weighted by
  //      the kept tables' WB / WP(i, dd - 1)
  T w[4] = {T(0), T(0), T(0), T(0)};            // WB V, WB P2, WP V, WP P2
  for (int g = threadIdx.x; g < s; g += k2dThreads) {
    const long long dd = (long long)(i + g) * n2 + l;
    const T vd = g == 0 ? own[0] : V[dd];
    const T pd = g == 0 ? own[1] : P2[dd];
    const T wb = WB[row + i + g - 1], wp = WP[row + i + g - 1];
    w[0] += wb * vd;
    w[1] += wb * pd;
    w[2] += wp * vd;
    w[3] += wp * pd;
  }
  block_sum(w, sh);
  if (threadIdx.x == 0) {
    const T b3 = s >= 1 ? WBP[il - 1] * __ldg(expcp + 1) : T(0);
    const T c3 = s >= 1 ? WPP[il - 1] * __ldg(exppup + 1) : T(0);
    const T wbp = w[0] * sc[sBp] * sc[sPPS] + w[1] * sc[sPSM] * sc[sPPS] + b3;
    const T wpp = w[2] * sc[sPPS] + w[3] * sc[sPSP] * sc[sPPS] + c3;
    const int u = min(s + 1, n2 - 1);
    WBP[il] = wbp;
    WPP[il] = wpp;
    WB[il] = __ldg(expcp + u) + wbp;            // pf4d.pf_wx_tables' rule at (i, i + s)
    WP[il] = __ldg(exppup + u) + wpp;
    WBPg[il] = wbp;
  }
  if (s < 3) return;

  // ---- WMv / WMp / WM(i, l): the splits k in [i, l - 4]
  T x[1] = {T(0)};
  for (int k = i + threadIdx.x; k <= l - kTurn - 1; k += k2dThreads) {
    const long long kl = (long long)k * n2 + l;
    const T vk = k == i ? own[0] : V[kl];
    const T pk = k == i ? own[1] : P2[kl];
    const T qbt = vk * __ldg(expml + kl) + pk * sc[sPSM] * sc[sB];
    const T pre = __ldg(mlbase + k - i) + (k - 1 >= i ? WM[row + k - 1] : T(0));
    x[0] += pre * qbt;
  }
  block_sum(x, sh);
  if (threadIdx.x == 0) {
    const T base1 = __ldg(mlbase + 1);
    WMv[il] = own[0] * __ldg(expml + il) + WMv[il - 1] * base1;
    WMp[il] = own[1] * sc[sPSM] * sc[sB] + WMp[il - 1] * base1;
    WM[il] = x[0] + WM[il - 1] * base1;
  }
}

template <typename T>
__device__ __forceinline__ T plane(const PfAssembleTable& t, int r, int tt, int i, int j) {
  const int n2 = t.n + 2;
  const int4 o = read_offsets(r);
  const int tp = tt + o.x, sp = t.s - o.y, row = i + o.z, col = j + o.w;
  if (tp >= t.T || sp < 0 || row >= n2 || col < 0 || col >= n2) return T(0);
  return __ldg(static_cast<const T*>(t.plane[r]) + (((long long)tp * t.S + sp) * n2 + row) * n2 + col);
}

template <typename T>
__global__ void __launch_bounds__(kCellThreads) pf_assemble_kernel(const __grid_constant__ PfAssembleTable t) {
  const int n = t.n, s = t.s, n2 = n + 2;
  const long long cells = (long long)t.TB * t.IB * n2;
  const long long e = (long long)blockIdx.x * kCellThreads + threadIdx.x;
  if (e >= cells) return;
  const int j = (int)(e % n2), i = (int)(e / n2 % t.IB), tt = (int)(e / n2 / t.IB);
  T* out = static_cast<T*>(t.out) + e;          // out[q * cells]
  if (!valid_cell(n, s, tt, i, j)) {
#pragma unroll
    for (int q = 0; q < kAssembled; ++q) out[q * cells] = T(0);
    return;
  }
  const T* hist = static_cast<const T*>(t.hist) + e;
  const T* stn = static_cast<const T*>(t.stn) + e;
  const T* estp = static_cast<const T*>(t.estp);
  const unsigned char* canp = static_cast<const unsigned char*>(t.canp);
  const int* ptype = static_cast<const int*>(t.ptype);
  const T ap = *static_cast<const T*>(t.expap);
  const T bp = *static_cast<const T*>(t.expbp);
  const T cp1 = static_cast<const T*>(t.expcp)[1];
  const T PB = *static_cast<const T*>(t.exppb);
  const int k = j + tt + 2, l = i + s;

  // PL at (i, j), PR at (k, l), PO at (i, l): iloop (stack + interior sum
  // where the pair can pair), the multiloop closures, the b3 branch
  const long long ij = (long long)i * n2 + j, kl = (long long)k * n2 + l, iln = (long long)i * n2 + l;
  T PL = T(0), PR = T(0), PO = T(0);
  if (ptype[ij] > 0) {
    const T iloop = canp[ij] ? plane<T>(t, rPL, tt, i, j) * __ldg(estp + ij) + stn[0] : T(0);
    const T ml = (plane<T>(t, rPLm10, tt, i, j) + plane<T>(t, rPLm01, tt, i, j)) * ap * bp * bp;
    const T b3 = j >= i + kTurn + 1 ? plane<T>(t, rPfromL, tt, i, j) : T(0);
    PL = iloop + ml + b3;
  }
  if (ptype[kl] > 0) {
    const T iloop = canp[kl] ? plane<T>(t, rPR, tt, i, j) * __ldg(estp + kl) + stn[cells] : T(0);
    const T ml = (plane<T>(t, rPRm10, tt, i, j) + plane<T>(t, rPRm01, tt, i, j)) * ap * bp * bp;
    const T b3 = l >= k + kTurn + 1 ? plane<T>(t, rPfromR, tt, i, j) : T(0);
    PR = iloop + ml + b3;
  }
  if (ptype[iln] > 0) {
    const T iloop = canp[iln] ? plane<T>(t, rPO, tt, i, j) * __ldg(estp + iln) + stn[2 * cells] : T(0);
    const T ml = (plane<T>(t, rPOm10, tt, i, j) + plane<T>(t, rPOm01, tt, i, j)) * ap * bp * bp;
    const T b3 = l >= i + kTurn + 1 ? plane<T>(t, rPfromO, tt, i, j) : T(0);
    PO = iloop + ml + b3;
  }
  out[0] = PL;
  out[cells] = PR;
  out[2 * cells] = PO;
  out[3 * cells] = PO * bp + hist[hRiPOm00 * cells] + hist[hRlPOm00 * cells];           // POmloop00
  out[4 * cells] = hist[hRiPOm10 * cells] + hist[hRlPOm10 * cells];                     // POmloop10
  out[5 * cells] = plane<T>(t, rPRm01s0, tt, i, j) * cp1 + hist[hRlPRm01 * cells];      // PRmloop01
  out[6 * cells] = hist[hRiPfromO * cells] + hist[hRlPfromO * cells] + (PL + PR) * PB;  // PfromO
  out[7 * cells] = hist[hRiPMm10 * cells] + hist[hRlPMm10 * cells];                     // base PMmloop10
}

template <typename T>
__global__ void __launch_bounds__(kCellThreads) pf_store_kernel(const __grid_constant__ PfStoreTable t) {
  const int n = t.n, s = t.s, n2 = n + 2, d = blockIdx.y;
  const long long nn = (long long)n2 * n2;
  const int rows = d < kFamilies + kCMats ? t.TB : d == kFamilies + kCMats ? t.T : min(s, t.T - 1) + 1;
  const long long e = (long long)blockIdx.x * kCellThreads + threadIdx.x;
  if (e >= rows * nn) return;
  const int tt = (int)(e / nn), r = (int)(e / n2 % n2), c = (int)(e % n2);
  // the source cell (tt, i, j) of destination element (tt, r, c): the
  // families' own rows, the C skews' rows l = i + s, PKD / PKE's diagonals
  // a = j - i (the plain write-back's unskew)
  int f, i = r, j = c;
  long long dst;
  T* out;
  if (d < kFamilies) {
    f = d;
    out = static_cast<T*>(t.dst[d]);
    dst = ((long long)tt * t.S + s) * nn + e % nn;
  } else if (d < kFamilies + kCMats) {
    f = t.csrc[d - kFamilies];
    out = static_cast<T*>(t.cdst[d - kFamilies]);
    dst = ((long long)tt * t.S + s) * nn + e % nn;
    i = r - s;
  } else {
    f = t.pk;
    j = r + c;
    if (d == kFamilies + kCMats) {
      out = static_cast<T*>(t.pkd);
      dst = ((long long)tt * t.S + s) * nn + e % nn;
    } else {
      out = static_cast<T*>(t.pke);
      dst = ((long long)tt * (t.S + t.T + 2) + s - tt) * nn + e % nn;
    }
  }
  T v = T(0);
  if (tt < t.TB && i >= 0 && i < t.IB && j < n2 && valid_cell(n, s, tt, i, j))
    v = __ldg(static_cast<const T*>(t.src[f]) + ((long long)tt * t.IB + i) * n2 + j);
  out[dst] = v;
}

// Every table: n >= 1 and 0 <= s <= n - 1.
template <typename Table>
bool load(Table* t, const void* table) {
  std::memcpy(t, table, sizeof(Table));
  return t->n >= 1 && t->s >= 0 && t->s <= t->n - 1;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns
// cudaGetLastError() after its launch: 0 on success.

extern "C" int ccj_pfbody_table_bytes(int which) {
  switch (which) {
    case 0: return (int)sizeof(PfSpan2dTable);
    case 1: return (int)sizeof(PfAssembleTable);
    case 2: return (int)sizeof(PfStoreTable);
    default: return -1;
  }
}

// The grammar's constants the kernels hold: 0 MAXLOOP, 1 TURN.
extern "C" int ccj_pfbody_const(int which) { return which == 0 ? kML : which == 1 ? kTurn : -1; }

extern "C" int ccj_pf_span2d(const void* table, void* stream) {
  PfSpan2dTable t;
  if (!load(&t, table) || t.S < t.s) return (int)cudaErrorInvalidValue;
  if (t.f64)
    pf_span2d_kernel<double><<<t.n + 2, k2dThreads, 0, (cudaStream_t)stream>>>(t);
  else
    pf_span2d_kernel<float><<<t.n + 2, k2dThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

extern "C" int ccj_pf_assemble(const void* table, void* stream) {
  PfAssembleTable t;
  if (!load(&t, table) || t.TB < 1 || t.IB < 1 || t.IB > t.n + 2) return (int)cudaErrorInvalidValue;
  const long long cells = (long long)t.TB * t.IB * (t.n + 2);
  const unsigned blocks = (unsigned)((cells + kCellThreads - 1) / kCellThreads);
  if (t.f64)
    pf_assemble_kernel<double><<<blocks, kCellThreads, 0, (cudaStream_t)stream>>>(t);
  else
    pf_assemble_kernel<float><<<blocks, kCellThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

// The C skews' rows l = i + s cover [s, s + IB): every row of the plane
// past it (l >= n2) is 0 only where IB >= n2 - s, which gapped4.bucket_dims
// guarantees and the wrapper checks.
extern "C" int ccj_pf_store(const void* table, void* stream) {
  PfStoreTable t;
  if (!load(&t, table) || t.TB < 1 || t.TB > t.T || t.TB < t.s - 1 || t.IB > t.n + 2 ||
      t.IB < t.n + 2 - t.s)
    return (int)cudaErrorInvalidValue;
  const long long nn = (long long)(t.n + 2) * (t.n + 2);
  const dim3 grid((unsigned)((t.T * nn + kCellThreads - 1) / kCellThreads), kFamilies + kCMats + 2);
  if (t.f64)
    pf_store_kernel<double><<<grid, kCellThreads, 0, (cudaStream_t)stream>>>(t);
  else
    pf_store_kernel<float><<<grid, kCellThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
