// span_store: the gapped step's write-back of one span into the state, every
// destination in one launch, hand-written for Hopper (sm_90a).
//
// Sources: the tt loop's 14 families, int32 [B, >= TB, IB, n2] slabs
// (cuda_ops.STEP_FAMILIES), packed here (clamp to [-32768, 32767] on the
// span's valid cells, SAT16 elsewhere), and span_assemble's eight packed
// int16 families [8, B, TB, IB, n2] (cuda_ops.ASSEMBLED), row r being
// i = i0 + r.  Destinations: up to 40 int16 views [B, TT, R, n2] into the
// state, each written whole:
//
//   plain:  dest[b, tt, rd, j] = slab[b, tt, rd + r0, j]
//   skewed: dest[b, tt, rd, a] = slab[b, tt, rd, i0 + rd + a]      (PKD, PKE)
//
// with SAT16 where tt >= TB, the slab row lies outside [0, IB) or the
// column past n2.  The layouts make them: the dense family slot at span s
// (its rows IB .. n2 SAT16), the C skews' rows l = i + s (r0 = -s: the
// rows l < s SAT16), a packed segment's block and C rows from i = 1, a row
// shard's own rows (and a staging slab for C rows another shard owns),
// PKD[:, :, s] and PKE[:, tt, s - tt] (a strided view, tt <= min(s, T - 1)).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusion of
// the JAX span step's pack and write-back, ccj_tpu/engine/gapped4.py:472-495
// and update_pk_skews4 (:210-229), which the port ran as ~80 eager PyTorch
// ops a span (cuda_ops.span_store_ref, the plain version).
//
// Bound: bytes, every destination element written once (2 B) and each
// source element a valid cell of a destination takes read once.  Design: a
// warp writes one destination row (b, tt, rd), its lanes on 32 consecutive
// j at a time, so its stores and its source row's loads (columns j, or
// skewed i0 + rd + a) are contiguous; a block is 8 rows of one
// destination, the launch's blocks laid out destination by destination.
// A row past the slab's tt rows or rows is SAT16 and reads nothing.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kLoops = 14;              // cuda_ops.STEP_FAMILIES
constexpr int kXs = 8;                  // cuda_ops.ASSEMBLED
constexpr int kMaxDests = 40;           // cuda_ops.STORE_MAX_DESTS
constexpr int kLanes = 32;
constexpr int kWarps = 8;                // cuda_ops.STORE_BLOCK_ROWS: rows a block
constexpr int kThreads = kLanes * kWarps;
constexpr int kSAT16 = 32767;

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py.
struct Plane {                // Plane: int32 [B, >= TB, IB, n2], any strides
  const int* p;
  long long s[4];
};
struct Dest {                 // StoreDestC: int16 [B, TT, R, n2]
  short* p;
  long long st[4];
  int src, skew, TT, R, r0, block0;   // block0: the launch's first block on it
};
struct StoreTable {
  Plane loop[kLoops];
  const short* xs;            // [8, B, TB, IB, n2]
  long long xst[5];
  Dest d[kMaxDests];
  int nd, blocks, B, TB, IB, n2, n, s, i0;
};

__global__ void __launch_bounds__(kThreads) store_kernel(const __grid_constant__ StoreTable t) {
  int k = 0;                  // the block's destination (uniform)
  while (k + 1 < t.nd && t.d[k + 1].block0 <= (int)blockIdx.x) ++k;
  const Dest& D = t.d[k];
  const int lane = threadIdx.x % kLanes;
  const int row = ((int)blockIdx.x - D.block0) * kWarps + (int)threadIdx.x / kLanes;
  if (row >= t.B * D.TT * D.R) return;
  const int rd = row % D.R;
  const int tt = (row / D.R) % D.TT;
  const int b = row / (D.R * D.TT);
  const int r = rd + D.r0;
  const int i = t.i0 + r;
  short* out = D.p + b * D.st[0] + tt * D.st[1] + rd * D.st[2];
  if (tt >= t.TB || r < 0 || r >= t.IB) {      // no slab row: SAT16
    for (int j = lane; j < t.n2; j += kLanes) out[j * D.st[3]] = (short)kSAT16;
    return;
  }
  const int c0 = D.skew ? i : 0;               // the slab column of j = 0
  if (D.src < kLoops) {
    const Plane& L = t.loop[D.src];
    const int* src = L.p + b * L.s[0] + tt * L.s[1] + r * L.s[2];
    // the row's valid columns: col >= i, col + tt + 2 <= i + s, i >= 1, i + s <= n
    const bool live = i >= 1 && i + t.s <= t.n;
    const int lo = i, hi = i + t.s - tt - 2;
    for (int j = lane; j < t.n2; j += kLanes) {
      const int col = c0 + j;
      int v = kSAT16;
      if (live && col >= lo && col <= hi && col < t.n2)
        v = min(max(__ldg(src + col * L.s[3]), -32768), kSAT16);
      out[j * D.st[3]] = (short)v;
    }
  } else {
    const short* src = t.xs + (D.src - kLoops) * t.xst[0] + b * t.xst[1] + tt * t.xst[2] +
                       r * t.xst[3];
    for (int j = lane; j < t.n2; j += kLanes) {
      const int col = c0 + j;
      out[j * D.st[3]] = col < t.n2 ? __ldg(src + col * t.xst[4]) : (short)kSAT16;
    }
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_store_table_bytes() { return (int)sizeof(StoreTable); }

// (destinations, destination rows a block): checked against cuda_ops' constants
// at load.
extern "C" void ccj_store_limits(int* out) {
  out[0] = kMaxDests;
  out[1] = kWarps;
}

// One span's write-back from `table` (one StoreTable) on `stream`.
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int ccj_span_store(const void* table, void* stream) {
  StoreTable t;
  std::memcpy(&t, table, sizeof(t));
  if (t.nd < 1 || t.nd > kMaxDests || t.B < 1 || t.TB < 1 || t.IB < 1 || t.n2 < 1 ||
      t.blocks < 1)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < t.nd; ++k)
    if (t.d[k].src < 0 || t.d[k].src >= kLoops + kXs) return (int)cudaErrorInvalidValue;
  store_kernel<<<t.blocks, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
