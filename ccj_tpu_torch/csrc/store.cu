// span_store: the gapped step's write-back of one span into the state, every
// destination in one launch, hand-written for Hopper (sm_90a).
//
// Sources: the tt loop's 14 families, int32 [B, >= TB, IB, n2] slabs
// (cuda_ops.STEP_FAMILIES), packed here (clamp to [-32768, 32767]), and
// span_assemble's eight packed int16 families [8, B, TB, IB, >= n2]
// (cuda_ops.ASSEMBLED, SAT16 off the span's valid cells as span_assemble
// writes them), row r being i = i0 + r; every source has a unit j stride.
// Destinations: up to 40 int16 views [B, TT, R, n2] into the state, each
// written whole:
//
//   plain:  dest[b, tt, rd, j] = slab[b, tt, rd + r0, j]
//   skewed: dest[b, tt, rd, a] = slab[b, tt, rd, i0 + rd + a]      (PKD, PKE)
//
// on the span's valid cells (i >= 1, i + s <= n, the slab column in
// [i, i + s - tt - 2]) and SAT16 everywhere else: where tt >= TB, the
// slab row lies outside [0, IB) or the column outside that band.  The
// layouts make them: the dense family slot at span s (its rows IB .. n2
// SAT16), the C skews' rows l = i + s (r0 = -s: the rows l < s SAT16), a
// packed segment's block and C rows from i = 1, a row shard's own rows
// (and a staging slab for C rows another shard owns), PKD[:, :, s] and
// PKE[:, tt, s - tt] (a strided view, tt <= min(s, T - 1)).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusion of
// the JAX span step's pack and write-back, ccj_tpu/engine/gapped4.py:472-495
// and update_pk_skews4 (:210-229), which the port ran as ~80 eager PyTorch
// ops a span (cuda_ops.span_store_ref, the plain version).
//
// Bound: bytes, every destination element written once (2 B) and each
// source element of a valid cell a destination takes read once; no
// arithmetic worth counting.  At n=200 it writes ~175 MB a span, most of
// it SAT16 (the dense slots' rows past IB, the tt rows past TB, the
// columns off the band).  What held the first version (a warp a
// destination row, 2-byte stores, 64-bit index products, a linear search
// for a block's destination) at 12-28 % of the bound was fixed cost per
// row and per element, not bytes.  Design: every destination of the
// layouts has a (b, tt) plane of R x n2 int16 that is one contiguous run
// (its row stride is n2), so a block writes one chunk of a run, 16-byte
// vectors of 8 elements, each thread kVec = 2 of them in flight (the loads
// of both first, then the stores; 1, 4 and 8 measured slower on an H100,
// PERF.md); a run's elements before its first 16-byte boundary and after
// its last one are the partial first and last vectors, written element
// by element.  A vector's (rd, j) comes from its flat offset once, with
// one division, and each of its rows' band once; off the band an element
// is SAT16 without a load.  For xs that is what span_assemble leaves
// there: the kernel relies on it (span_store_ref copies xs as it is, and
// tests/test_torch_store_table.py holds span_assemble_ref's xs to SAT16
// off the valid cells).  (Staging each warp's
// 256 elements in shared memory so that its lanes load them coalesced,
// 32 apart, was slower on an H100: 0.165 against 0.130 ms at n=200 span
// 135.)  The run's (b, tt) base is one 64-bit product a block, every
// offset within a run or a source plane 32-bit (the wrapper checks that
// they fit).  A block finds its destination by a binary search over the
// prefix table the wrapper computes (dblock0).  A destination whose row
// stride is not n2 (no layout makes one) takes the same kernel a row a
// run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLoops = 14;              // cuda_ops.STEP_FAMILIES
constexpr int kXs = 8;                  // cuda_ops.ASSEMBLED
constexpr int kMaxDests = 40;           // cuda_ops.STORE_MAX_DESTS
constexpr int kThreads = 128;
constexpr int kVec = 2;                 // 16-byte vectors a thread, in flight together
constexpr int kBlockVecs = kThreads * kVec;   // cuda_ops.STORE_BLOCK_VECS
constexpr int kSAT16 = 32767;

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py (StoreTable):
// every 64-bit field first, then the 32-bit ones, so the wrapper packs it
// with one struct format.
struct StoreTable {
  const int* loop[kLoops];    // [B, >= TB, IB, n2], unit j stride
  const short* xs;            // [8, B, TB, IB, >= n2], unit j stride
  short* dp[kMaxDests];       // destination views [B, TT, R, n2], unit j stride
  long long dst0[kMaxDests];  // their b strides
  long long dst1[kMaxDests];  // their tt strides
  int lst[kLoops][3];         // the loops' b, tt, row strides
  int xst[4];                 // xs' family, b, tt, row strides
  int drow[kMaxDests];        // row stride: n2 makes each (b, tt) plane one run
  int dTT[kMaxDests], dR[kMaxDests], dr0[kMaxDests], dskew[kMaxDests];
  int dsrc[kMaxDests];        // the source: a loop family, or kLoops + an xs family
  int dchunks[kMaxDests];     // blocks a run
  int dblock0[kMaxDests];     // the launch's first block on the destination
  int nd, blocks, B, TB, IB, n2, n, s, i0;
};

// A destination row's band: view columns [lo, hi] take the source element
// at src + j; every other column is SAT16.
struct Band {
  int lo, hi, src;
};

struct Run {                  // what a block's destination and run fix
  int n2, r0, skew, i0, s, n, TB, IB, tt;
  int plane, rs;              // the source's (b, tt) plane offset and row stride

  __device__ __forceinline__ Band band(int rd) const {
    const int r = rd + r0, i = i0 + r;
    Band w{1, 0, 0};
    if (tt < TB && r >= 0 && r < IB && i >= 1 && i + s <= n) {
      const int c0 = skew ? i : 0;     // the source column of view column 0
      w.lo = i - c0;
      w.hi = i + s - tt - 2 - c0;
      w.src = plane + r * rs + c0;
    }
    return w;
  }
};

template <typename T>
__device__ __forceinline__ int value(const T* src, int k) {
  const int v = __ldg(src + k);
  return sizeof(T) == 4 ? min(max(v, -32768), kSAT16) : v;
}

__device__ __forceinline__ unsigned pair(int lo, int hi) {
  return (unsigned)(lo & 0xffff) | ((unsigned)hi << 16);
}

// The block's chunk of one run: L elements from `base`, view row rd0 at
// its element 0 (a run is a whole (b, tt) plane, or one row).
template <typename T>
__device__ __forceinline__ void store_run(const Run& u, const T* __restrict__ src,
                                          short* __restrict__ base, int L, int rd0, int chunk) {
  const int n2 = u.n2;
  const int a0 = (int)((reinterpret_cast<uintptr_t>(base) >> 1) & 7);
  short* const vbase = base - a0;      // 16-byte aligned: vector v is vbase[8 v, 8 v + 8)
  const int nvec = (L + a0 + 7) >> 3;
  uint4 out[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int v = chunk * kBlockVecs + k * kThreads + (int)threadIdx.x;
    if (v >= nvec) continue;
    const int e = 8 * v - a0;          // run element of the vector's first slot
    int rd = max(e, 0) / n2;
    int j = max(e, 0) - rd * n2;
    Band w = u.band(rd0 + rd);
    int x[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      x[m] = kSAT16;
      if (e + m >= 0 && e + m < L) {
#if defined(STORE_SKIP_LOADS)   // timing-only build (span_variants.py): no source load
        if (j >= w.lo && j <= w.hi) x[m] = w.src + j;
#else
        if (j >= w.lo && j <= w.hi) x[m] = value(src, w.src + j);
#endif
        if (++j == n2) {
          j = 0;
          w = u.band(rd0 + ++rd);
        }
      }
    }
    out[k] = make_uint4(pair(x[0], x[1]), pair(x[2], x[3]), pair(x[4], x[5]),
                        pair(x[6], x[7]));
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int v = chunk * kBlockVecs + k * kThreads + (int)threadIdx.x;
    if (v >= nvec) continue;
    const int e = 8 * v - a0;
    if (e >= 0 && e + 8 <= L) {
      *reinterpret_cast<uint4*>(vbase + 8 * v) = out[k];
    } else {                           // the run's partial first or last vector
      const uint4 o = out[k];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const unsigned wd = m < 2 ? o.x : m < 4 ? o.y : m < 6 ? o.z : o.w;
        if (e + m >= 0 && e + m < L) vbase[8 * v + m] = (short)(wd >> (16 * (m & 1)));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) store_kernel(const __grid_constant__ StoreTable t) {
  // A kernel launched after this one as its programmatic dependent (the
  // fills' span_wm, csrc/span2d.cu) may start once every block has begun:
  // it reads nothing this kernel writes before its griddepcontrol.wait.
  // Without such a launch after it this is a no-op.
  asm volatile("griddepcontrol.launch_dependents;" :::);
  const int blk = (int)blockIdx.x;
  int d = 0;                           // the last destination with dblock0 <= blk
#pragma unroll
  for (int step = 32; step > 0; step >>= 1)
    if (d + step < t.nd && t.dblock0[d + step] <= blk) d += step;
  const int chunks = t.dchunks[d];
  int run = blk - t.dblock0[d];
  const int chunk = run % chunks;
  run /= chunks;
  const int n2 = t.n2, R = t.dR[d], TT = t.dTT[d];
  const bool rowrun = t.drow[d] != n2;
  int rd0 = 0;
  if (rowrun) {
    rd0 = run % R;
    run /= R;
  }
  const int tt = run % TT, b = run / TT;
  short* const base = t.dp[d] + b * t.dst0[d] + tt * t.dst1[d] + (long long)rd0 * t.drow[d];
  const int L = rowrun ? n2 : R * n2;
  const int src = t.dsrc[d];
  Run u{n2, t.dr0[d], t.dskew[d], t.i0, t.s, t.n, t.TB, t.IB, tt, 0, 0};
  if (src < kLoops) {
    if (tt < t.TB) {
      u.plane = b * t.lst[src][0] + tt * t.lst[src][1];
      u.rs = t.lst[src][2];
    }
    store_run(u, t.loop[src], base, L, rd0, chunk);
  } else {
    if (tt < t.TB) {
      u.plane = (src - kLoops) * t.xst[0] + b * t.xst[1] + tt * t.xst[2];
      u.rs = t.xst[3];
    }
    store_run(u, t.xs, base, L, rd0, chunk);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_store_table_bytes() { return (int)sizeof(StoreTable); }

// (destinations, 16-byte vectors a block): checked against cuda_ops' constants
// at load.
extern "C" void ccj_store_limits(int* out) {
  out[0] = kMaxDests;
  out[1] = kBlockVecs;
}

// One span's write-back from `table` (one StoreTable) on `stream`.
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int ccj_span_store(const void* table, void* stream) {
  const StoreTable* t = static_cast<const StoreTable*>(table);
  if (t->nd < 1 || t->nd > kMaxDests || t->B < 1 || t->TB < 1 || t->IB < 1 || t->n2 < 1 ||
      t->blocks < 1)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < t->nd; ++k)
    if (t->dsrc[k] < 0 || t->dsrc[k] >= kLoops + kXs || t->dchunks[k] < 1 ||
        t->dTT[k] < 1 || t->dR[k] < 1 || (k > 0 && t->dblock0[k] < t->dblock0[k - 1]))
      return (int)cudaErrorInvalidValue;
  store_kernel<<<t->blocks, kThreads, 0, (cudaStream_t)stream>>>(*t);
  return (int)cudaGetLastError();
}
