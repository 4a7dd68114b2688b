// history_min: the gapped step's l-shrink / i-shrink history scans (RL and
// RI) in one launch a call, hand-written for Hopper (sm_90a).  One thread
// per output cell (b, tt, r, j): batch element b, tt row, row r (i = i0 +
// r), column j in [0, n2).  Over the parts of a HistTable (the dense
// layout's one window, or one window per prior segment of the packed
// layout) it takes
//
//   acc[b, tt, r, j] = min(acc, INF, min over parts p, spans u of
//                          win_p[b, tt, u, r, j] + w_p[b, u, r])
//
// over the terms whose history distance d = d0_p - u satisfies
//
//   RL (mode 0):  1 <= d <= (i + s) - (j + tt + 2) - g1       (l - k - g1)
//   RI (mode 1):  1 <= d <= (j - i) - g1,  and i >= 1
//
// and whose row r lies within the part's rows (r < Rw: rows past them, the
// C rows l >= n2 of the dense RI, give no term).  A part's tt rows past its
// own (tt >= TBw: the packed layout's earlier segments) read as SAT16, the
// value the plain version pads them with: those terms take part.
//
// The window is an int16 strided view straight into the state (a family's
// [tt, span, i, j] block, or a C skew's rows l = i + s), so nothing is
// cast or copied: the plain version (cuda_ops.history_min_ref, the scans as
// gapped4 / gapped5 wrote them) builds an int32 copy of the whole window
// and a where over it before its min.  All arithmetic is int32: a window
// value is at most SAT16 and a weight at most INF = 10^7, so no sum
// overflows.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusions of
// the JAX package's RL / RI closures, ccj_tpu/engine/gapped4.py:306-341
// (dense) and ccj_tpu/engine/gapped5.py:313-365 (packed), 16 calls a span.
//
// Bound: bytes.  Every window element is used by exactly one output cell
// (its (b, tt, r, j) and its span u), so the function reads each needed
// int16 element once, the weights, and reads and writes acc once; its
// add-min terms (two int32 operations each) are far below the int32 rate.
// This first version is simple and right: neighbouring threads take
// neighbouring j, so a warp's window loads coalesce (64 bytes a span) and
// its weight load is one broadcast; each thread walks its own admissible
// span range [max(0, d0 - bound), min(U, d0) - 1], so masked terms are
// never loaded.  It keeps acc in a register across all parts (one read and
// one write a cell), where the plain version made one int32 temporary per
// part.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxParts = 8;            // cuda_ops.HISTORY_MAX_PARTS
constexpr int kThreads = 256;
constexpr int kSAT16 = 32767;
constexpr int kINF = 10000000;

// One history window and its weights.  Mirrored field for field by
// ccj_tpu_torch/engine/cuda_ops.py:HistPart.
struct HistPart {
  const short* win;           // int16 [B, TBw, U, Rw, n2]
  long long ws[5];            // its element strides
  const int* w;               // int32 [B, U, >= R]
  long long wws[3];           // its element strides
  int TBw, U, Rw, d0;         // tt rows, spans, rows; span u has d = d0 - u
};

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py:HistTable.
struct HistTable {
  HistPart part[kMaxParts];
  int* acc;                   // int32 [B, TB, R, n2], updated in place
  long long as[4];            // its element strides
  int nparts, B, TB, R, n2, s, g1, mode, i0;
};

__global__ void __launch_bounds__(kThreads)
history_kernel(const __grid_constant__ HistTable t) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= t.R * t.n2) return;
  const int r = e / t.n2;
  const int j = e - r * t.n2;
  const int tt = blockIdx.y;
  const int b = blockIdx.z;
  const int i = t.i0 + r;
  // the largest admissible distance: d <= bound
  int bound;
  if (t.mode == 0)
    bound = (i + t.s) - (j + tt + 2) - t.g1;
  else
    bound = i >= 1 ? (j - i) - t.g1 : 0;

  int* ap = t.acc + b * t.as[0] + tt * t.as[1] + r * t.as[2] + j * t.as[3];
  int best = min(*ap, kINF);
  if (bound >= 1) {
    for (int p = 0; p < t.nparts; ++p) {
      const HistPart& P = t.part[p];
      if (r >= P.Rw) continue;
      const int ulo = max(0, P.d0 - bound);
      const int uhi = min(P.U, P.d0);          // u < uhi: d >= 1
      if (ulo >= uhi) continue;
      const int* wp = P.w + b * P.wws[0] + r * P.wws[2] + ulo * P.wws[1];
      if (tt < P.TBw) {
        const short* xp = P.win + b * P.ws[0] + tt * P.ws[1] + ulo * P.ws[2] +
                          r * P.ws[3] + j * P.ws[4];
        for (int u = ulo; u < uhi; ++u, xp += P.ws[2], wp += P.wws[1])
          best = min(best, (int)__ldg(xp) + __ldg(wp));
      } else {
        for (int u = ulo; u < uhi; ++u, wp += P.wws[1])
          best = min(best, kSAT16 + __ldg(wp));
      }
    }
  }
  *ap = best;
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_history_table_bytes() { return (int)sizeof(HistTable); }

extern "C" int ccj_history_max_parts() { return kMaxParts; }

// One history scan over the parts of `table` (one HistTable), on `stream`.
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int ccj_history_min(const void* table, void* stream) {
  HistTable t;
  std::memcpy(&t, table, sizeof(t));
  if (t.nparts < 0 || t.nparts > kMaxParts || t.B < 1 || t.B > 65535 ||
      t.TB < 1 || t.TB > 65535 || t.R < 0 || t.n2 < 0 || (t.mode != 0 && t.mode != 1))
    return (int)cudaErrorInvalidValue;
  if (t.R == 0 || t.n2 == 0) return 0;
  const dim3 grid((t.R * t.n2 + kThreads - 1) / kThreads, t.TB, t.B);
  history_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
