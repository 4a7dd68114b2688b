// minplus_window: masked min-plus window reduction, hand-written for Hopper
// (sm_90a).
//
//   out[i, j] = min(INF, min over q in [q_lo, Q) with mask(q, i, j) of
//                        slab[row0 + q, i, col0 + j] + w[q, j])
//
//   mask mode 0: none
//   mask mode 1: q <= c - j + i   (k-shrink bound d <= G - 1, c = s - 4 - tt)
//   mask mode 2: q <= j - i - c   (j-shrink bound d <= (j - i) - 1, c = 2)
//
// Replaces the TPU kernel ccj_tpu/engine/pallas_ops.py:_minplus_kernel
// (launched by minplus_suffix, pl.pallas_call at :70), whose function is
// exactly the serial tt loop's k-shrink and j-shrink reductions red_k /
// red_j (ccj_tpu/engine/ttloop.py:442-455): 13 calls per tt step.
//
// Bound: bytes, not operations.  int32 min-plus has no tensor-core form,
// and each slab element is read once: Q * I * J * 4 bytes per call.  At
// n = 100 that is at most 99 * 128 * 102 * 4 B ~= 5.2 MB, ~1.5 us at
// 3.35 TB/s, so launch cost dominates: a dense n = 100 fill makes
// 13 * sum_s (s - 1) ~= 63,000 launches.
//
// Design: one thread per (i, j), threads adjacent along j so the slab and
// weight reads of a warp coalesce; the q loop runs in registers and stops at
// the mask's last admissible q.  The slab is read in place through its
// strides (the window is never copied).  The kernel allocates nothing and
// launches on the caller's stream.  wgmma and TMA have no use here.  Each
// thread keeps one pair of loads in flight, so on the card the loop's
// memory latency, not the byte bound, sets the kernel's own time (PERF.md);
// splitting q across threads, or fusing the whole tt step into one kernel,
// is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kInf = 10000000;
constexpr int kBlockJ = 128;

__global__ void minplus_window_kernel(
    const int* __restrict__ slab, long long ss0, long long ss1, long long ss2,
    const int* __restrict__ w, long long ws0, long long ws1,
    int* __restrict__ out, int I, int J, int Q,
    int row0, int col0, int q_lo, int mode, int c) {
  const int j = blockIdx.x * kBlockJ + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= J || i >= I) return;
  int q_hi = Q - 1;
  if (mode == 1) {
    q_hi = min(q_hi, c - j + i);
  } else if (mode == 2) {
    q_hi = min(q_hi, j - i - c);
  }
  const int* sp = slab + (long long)row0 * ss0 + (long long)i * ss1 +
                  (long long)(col0 + j) * ss2;
  const int* wp = w + (long long)j * ws1;
  int acc = kInf;
  for (int q = q_lo; q <= q_hi; ++q) {
    const int v = __ldg(sp + (long long)q * ss0) + __ldg(wp + (long long)q * ws0);
    acc = min(acc, v);
  }
  out[(long long)i * J + j] = acc;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Strides are in elements.
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int ccj_minplus_window(
    const void* slab, long long ss0, long long ss1, long long ss2,
    const void* w, long long ws0, long long ws1, void* out,
    int I, int J, int Q, int row0, int col0, int q_lo, int mode, int c,
    void* stream) {
  if (I <= 0 || J <= 0) return 0;
  const dim3 block(kBlockJ);
  const dim3 grid((J + kBlockJ - 1) / kBlockJ, I);
  minplus_window_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)slab, ss0, ss1, ss2, (const int*)w, ws0, ws1, (int*)out,
      I, J, Q, row0, col0, q_lo, mode, c);
  return (int)cudaGetLastError();
}
