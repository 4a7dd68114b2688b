// p_split: the P(i, i+s) split contraction of one span, for every live row
// and batch element in one launch, hand-written for Hopper (sm_90a).
//
//   P(i, i+s) = min over a = j - i >= 0, b = d - j >= 1, c = k - d >= 1,
//               a + b + c <= s - 1, of
//               PKE[b - 1, a + c + 1, i, a] + PKD[c - 1, s - a - 1, i + a + 1, b - 1]
//
// (pseudo_loop.cc:166-179 over the diagonal skews PKE / PKD).  The sum is
// plain int32 with no saturation; SAT16 cells take part as values, and a
// PKD row past the operand's rows reads SAT16, as the plain version's
// SAT16 row padding does.  Only the live rows (i >= 1, i + s <= n) are
// computed; the caller's output holds INF everywhere else.
//
// Operands.  PKE is an int16 strided view [B, T, S + T + 2, >= R, n2]
// whose row r is i = i0 + r.  The factor-2 source is an int16 strided view
// X[B, A, T, NR, >= T] with an affine map from a: X's axis-1 index is
// sp0 + sp1 * a and its row ro0 + ro1 * a + r.  The unsharded fills pass
// PKD itself ([b, span, c - 1, row, b - 1]: sp = s - 1 - a, row = i + a + 1);
// the row-sharded ones a stack of the PKD rows each a needs, fetched from
// their owners (sp = a, row = r).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusion of
// ccj_tpu/engine/gapped3.py:69-123 (compute_P_span3's chunked a lanes),
// which the port ran as s - 1 eager passes a span, each over int32
// [B, T, T, IB] temporaries of the whole (b, c) square
// (cuda_ops.p_split_ref, its plain version).
//
// Bound: bytes.  Each admissible (a, b, c, i) term reads one PKE element
// and one PKD element that no other term reads (for a fixed row, (a, b, c)
// picks distinct cells of both skews; across rows the cells differ by i),
// so the function reads 4 bytes a term and writes one int32 a row: at
// n = 200, span 135, 65 live rows x C(135, 3) = 26.1 M terms, 104 MB,
// 0.031 ms at 3.35 TB/s.  So the kernel can only gain by moving those
// bytes in whole sectors.  The first version's lanes walked a, which
// coalesced the PKE loads but put each lane's PKD load on its own 32-byte
// sector for 2 useful bytes.
//
// The design.  Fix a row and m = a + c + 1 (c = m - 1 - a): the terms over
// (b - 1, a) form the rectangle b - 1 in [0, s - 1 - m], a in [0, m - 2]
// (the constraint a + b + c <= s - 1 is b - 1 + m <= s - 1, so the
// inadmissible triangle of (b - 1, m) is skipped whole, and nothing of a
// rectangle is), whose two operands are each contiguous along their own
// axis:
//
//   A[b - 1][a] = PKE[b - 1, m, i, a]            contiguous along a
//   B[a][b - 1] = X[sp(a), m - 2 - a, ro(a) + r, b - 1]   contiguous along b - 1
//
// One block per (b, four neighbouring live rows, m); each warp walks its
// own row's rectangle in 32 x 32 tiles (a warp needs no other warp: no
// block barrier until the end).  The four rows' operand rows lie next to
// each other in memory (PKE[b - 1, m, i .. i + 3, a], X rows
// ro(a) + r .. + 3), so a block's warps read neighbouring segments.  Per
// tile a warp loads the 32 rows of A into registers (lanes along a:
// 64-byte row segments) and the 32 rows of B into its own shared-memory
// tile (lanes along b - 1, 64-byte segments), as int32 with a padded row
// of 33 so that the transposed read B[a][b - 1] of a warp hits 32 banks;
// the 64 loads of a lane are independent and issued together, so a warp
// keeps 4 KB in flight.  Then each lane adds its 32 A elements to their
// transposed B elements and keeps the minimum in a register, which warp
// shuffles reduce to one atomicMin a warp.  Blocks over (rows, m) fill
// the card at n = 100's short spans as well (16 x 35 blocks of four warps
// at span 37).  (64 x 64 tiles copied with cp.async, 128-byte requests
// and both operands in shared memory, were no faster at chip_smoke.py's
// phase 2d shapes, and went.)

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kTile = 32;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSAT16 = 32767;
constexpr int kINF = 10000000;

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py:PSplitTable.
struct PSplitTable {
  const short* pke;           // int16 [B, T, S + T + 2, >= R, n2]
  long long ks[5];
  const short* pkd;           // int16 [B, A, T, NR, >= T]
  long long ds[5];
  int* out;                   // int32 [B, R], INF where no row is live
  long long os[2];
  int sp0, sp1, ro0, ro1, nrows;
  int B, R, s, n, i0, lo, nlive;
};

__global__ void __launch_bounds__(kThreads)
p_split_kernel(const __grid_constant__ PSplitTable t) {
  __shared__ int sB[kWarps][kTile][kTile + 1];   // each warp's B[a][b - 1] tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int live = blockIdx.x * kWarps + warp;   // the warp's live row
  if (live >= t.nlive) return;
  const int b = blockIdx.z;
  const int r = t.lo - t.i0 + live;
  const int m = 2 + blockIdx.y;
  const int nbb = t.s - m;                    // b - 1 in [0, s - 1 - m]
  const int na = m - 1;                       // a in [0, m - 2]
  const int tbb = (nbb + kTile - 1) / kTile;
  const int ntiles = tbb * ((na + kTile - 1) / kTile);
  const short* pke = t.pke + b * t.ks[0] + m * t.ks[2] + r * t.ks[3];
  const short* pkd = t.pkd + b * t.ds[0];
  int(*sw)[kTile + 1] = sB[warp];

  int best = kINF;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int a0 = (tile / tbb) * kTile;
    const int bb0 = (tile % tbb) * kTile;
    int va[kTile], vb[kTile];
    const int a = a0 + lane;                  // A: rows b - 1, lanes along a
    const int bb = bb0 + lane;                // B: rows a, lanes along b - 1
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      va[q] = kINF;                           // outside the rectangle: loses
      if (a < na && bb0 + q < nbb) va[q] = __ldg(pke + (bb0 + q) * t.ks[1] + a * t.ks[4]);
      const int aq = a0 + q;
      const int row = r + t.ro0 + t.ro1 * aq;
      vb[q] = kSAT16;                         // factor-2 rows past X read SAT16
      if (aq < na && bb < nbb && row >= 0 && row < t.nrows)
        vb[q] = __ldg(pkd + (t.sp0 + t.sp1 * aq) * t.ds[1] + (m - 2 - aq) * t.ds[2] +
                      row * t.ds[3] + bb * t.ds[4]);
    }
    __syncwarp();                             // the last tile's reads are done
#pragma unroll
    for (int q = 0; q < kTile; ++q) sw[q][lane] = vb[q];
    __syncwarp();
    // A[b - 1 = bb0 + q][a] + B[a][b - 1 = bb0 + q]
#pragma unroll
    for (int q = 0; q < kTile; ++q) best = min(best, va[q] + sw[lane][q]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0 && best < kINF) atomicMin(t.out + b * t.os[0] + r * t.os[1], best);
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_p_split_table_bytes() { return (int)sizeof(PSplitTable); }

// The P split of the span whose operands `table` (one PSplitTable) holds,
// on `stream`.  Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int ccj_p_split(const void* table, void* stream) {
  PSplitTable t;
  std::memcpy(&t, table, sizeof(t));
  if (t.B < 1 || t.B > 65535 || t.nlive < 0 || t.s < 0 || t.s > 65537)
    return (int)cudaErrorInvalidValue;
  if (t.nlive == 0 || t.s < 3) return 0;
  const dim3 grid((t.nlive + kWarps - 1) / kWarps, t.s - 2, t.B);   // m in [2, s - 1]
  p_split_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
