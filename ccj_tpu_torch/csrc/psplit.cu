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
// 0.031 ms at 3.35 TB/s.  This first version is simple and right: a block
// (or several, joined by atomicMin, where a span has few rows) per live
// (b, i) row; each warp takes (b - 1, m = a + c + 1) pairs (admissible for
// every a <= m - 2 exactly when b - 1 + m <= s - 1) and its lanes take
// neighbouring a, so the PKE loads coalesce along a; the PKD loads are one
// sector a lane.  The minimum stays in a register, then warp shuffles and
// shared memory reduce it to one atomicMin a block.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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
  int B, R, s, n, i0, lo, nlive, split;
};

__global__ void __launch_bounds__(kThreads)
p_split_kernel(const __grid_constant__ PSplitTable t) {
  const int b = blockIdx.z;
  const int r = t.lo - t.i0 + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int side = t.s - 2;                   // b - 1 in [0, s - 3], m in [2, s - 1]
  const int pairs = side * side;
  const int stride = t.split * kWarps;

  const short* pke = t.pke + b * t.ks[0] + r * t.ks[3];
  const short* pkd = t.pkd + b * t.ds[0];
  int best = kINF;
  for (int q = blockIdx.x * kWarps + warp; q < pairs; q += stride) {
    const int bb = q / side;
    const int m = 2 + (q - bb * side);
    if (bb + m > t.s - 1) continue;
    const short* f1 = pke + bb * t.ks[1] + m * t.ks[2];
    for (int a = lane; a <= m - 2; a += 32) {
      const int cc = m - 2 - a;
      const int row = r + t.ro0 + t.ro1 * a;
      const int x = t.sp0 + t.sp1 * a;
      const int v2 = (row >= 0 && row < t.nrows)
          ? (int)__ldg(pkd + x * t.ds[1] + cc * t.ds[2] + row * t.ds[3] + bb * t.ds[4])
          : kSAT16;
      best = min(best, (int)__ldg(f1 + a * t.ks[4]) + v2);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
  __shared__ int warp_min[kWarps];
  if (lane == 0) warp_min[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = warp_min[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = min(m, warp_min[w]);
    if (m < kINF) atomicMin(t.out + b * t.os[0] + r * t.os[1], m);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_p_split_table_bytes() { return (int)sizeof(PSplitTable); }

// The P split of the span whose operands `table` (one PSplitTable) holds,
// on `stream`; the table's `split` (blocks a row) is chosen here and
// written back.  Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int ccj_p_split(void* table, void* stream) {
  PSplitTable t;
  std::memcpy(&t, table, sizeof(t));
  if (t.B < 1 || t.B > 65535 || t.nlive < 0 || t.nlive > 65535 || t.s < 0)
    return (int)cudaErrorInvalidValue;
  if (t.nlive == 0 || t.s < 3) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // about four blocks an SM over the launch, each warp with at least a few
  // (b - 1, m) pairs
  const int pairs = (t.s - 2) * (t.s - 2);
  const int rows = t.nlive * t.B;
  int split = (4 * sms + rows - 1) / rows;
  split = std::max(1, std::min(split, pairs / (4 * kWarps)));
  t.split = split;
  std::memcpy(table, &t, sizeof(t));
  const dim3 grid(split, t.nlive, t.B);
  p_split_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
