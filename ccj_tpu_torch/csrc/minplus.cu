// minplus_group: a group of masked min-plus window reductions in one
// launch, hand-written for Hopper (sm_90a).  For each window g of the group,
// evaluated at the launch's tt:
//
//   out[g, i, j] = min(INF, min over q in [q_lo, Q) with mask(q, i, j) of
//                           slab[row0 + q, i, scol + j] + w[q, wcol + j])
//
//   mask mode 0: none
//   mask mode 1: q <= c - j + i   (k-shrink bound d <= G - 1, c = s - 4 - tt)
//   mask mode 2: q <= j - i - c   (j-shrink bound d <= (j - i) - 1, c = 2)
//
// row0, scol, wcol and c are affine in tt (base + step * tt), so a table of
// window descriptors is built once per span and each tt step passes only tt.
// A batch of B sequences shares one table: each descriptor has a batch
// stride for its slab and for each weight table (struct BatchStrides, zero
// for an unbatched group), block z covers descriptor z % D of batch element
// z / D (grid.z = D * B), and the output is [B, G, I, J].  The batch offset
// is 64-bit; within one element the offsets stay 32-bit (the wrapper checks
// each element's slab spans under 2^31 elements).  B = 1 launches its own
// instantiation with no batch offsets: holding the bases in registers, as
// the batched one must, took ptxas from 62 registers to 48 and the n = 100
// group from 8.1 to 10.8 us L2-hot on the card (chip_smoke.py).
// Two windows that read the same slab window under the same mask and differ
// only in their weights travel as one descriptor with a second weight table
// (w2) and a second output: the block reads each slab term once and feeds
// it to both.
//
// Replaces the TPU kernel ccj_tpu/engine/pallas_ops.py:_minplus_kernel
// (launched by minplus_suffix, pl.pallas_call at :70), whose function is
// exactly the serial tt loop's k-shrink and j-shrink reductions red_k /
// red_j (ccj_tpu/engine/ttloop.py:442-455): 13 windows per tt step, all
// reading rows >= tt + 1 and all read before the step writes row tt, so
// the 13 are independent and run here as one grouped launch.
//
// Bound: bytes, not operations.  int32 min-plus has no tensor-core form
// (no wgmma), and each admissible slab term the group needs is read once:
// at the main n = 100 step (TB = 64, IB = 102, J = 102) the 13 windows need
// 17.0 MB, 5.1 us at 3.35 TB/s.  What the design does about what held the
// one-thread-per-(i, j) kernel it replaces far from that bound:
//
// 1. Latency.  A block owns a tile of 32 j x kTileI i of one descriptor.
//    Its warps form kIGroups along i times kQGroups along q: the q groups
//    split the block's admissible q range between them (group g takes
//    q = qa + g, qa + g + kQGroups, ...), and each thread carries kRows i
//    rows with independent accumulators and unrolls q by kUnroll, so
//    kRows * kUnroll = 16 slab loads are in flight per thread, and the grid
//    holds 572 blocks at the main n = 100 step (102 before).  Slab offsets
//    are 32-bit (the wrapper checks that a slab spans under 2^31 elements),
//    which keeps the kernel at 64 registers and 4 blocks per SM.  Min over
//    int32 is exact and order-free, so any split of q gives bit-identical
//    results.  The q groups' partial minima meet in shared memory; warp w
//    then stores i row w of the tile.
// 2. Masked terms.  Both masks are linear in (q, i, j), so each block
//    computes the largest admissible q over its tile and a tile with
//    nothing admissible stores INF and exits; within a tile each thread
//    stops at its rows' last admissible q and predicates the rest.
// 3. Reuse.  w[q, j] does not depend on i: the block's i warps, and the
//    blocks of the same j tile, read one weight row, and the read-only
//    path (L1) serves the repeats.  Staging the weights in shared memory
//    (cp.async) put a barrier and a round of latency before each block's
//    first slab load and was slower on the card.  A slab term shared by
//    two windows (a descriptor with w2) is loaded once for both.
// 4. Host launch paths.  One launch per group (per tt step) instead of one
//    per window; the descriptors travel by value as a __grid_constant__
//    kernel parameter (at most 16 x 128 B), so no descriptor is copied to
//    the device.
//
// What is left between the kernel and its bound: its 32-lane row reads
// start at 4-byte offsets and touch 5 sectors for 4 sectors' worth, masked
// tiles leave blocks with unequal work and the last wave part-empty, the
// last j tile of 102 columns holds 6 of 32 lanes, and launch and ramp are a
// sizeable part of a ~10 us kernel.
//
// No TMA: it needs 16-byte-aligned global bases and strides, and the slabs'
// row strides (4 * 102 B, 4 * 166 B at n = 100) and red_j's column offset tt
// give neither; register loads work at any alignment.  The slab is read in
// place through its strides (no window is copied); the kernel allocates
// nothing and launches on the caller's stream.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kInf = 10000000;
constexpr int kMaxWindows = 16;
constexpr int kTileJ = 32;                        // one lane per j
constexpr int kRows = 4;                          // i rows per thread
constexpr int kIGroups = 2;                       // warps along i
constexpr int kQGroups = 4;                       // warps splitting q
constexpr int kThreads = 32 * kIGroups * kQGroups;
constexpr int kTileI = kRows * kIGroups;
constexpr int kUnroll = 4;                        // q values per iteration
static_assert(kQGroups >= kRows, "every tile row needs a storing warp");

// One descriptor as a function of tt.  Mirrored field for field by
// ccj_tpu_torch/engine/cuda_ops.py:Window (ctypes); strides in elements.
struct Window {
  const int* slab;
  long long ss0, ss1, ss2;
  const int* w;
  long long ws0, ws1;
  const int* w2;        // a second weight table on the same slab window, or null
  long long w2s0, w2s1;
  int row0_b, row0_s;   // slab row of q = 0
  int scol_b, scol_s;   // slab column of j = 0
  int wcol_b, wcol_s;   // weight column of j = 0 (w and w2 alike)
  int q_lo, mode;
  int c_b, c_s;         // the mask's c
  int out, out2;        // output planes of w and w2
};

// Per-descriptor batch strides in elements, mirrored by
// ccj_tpu_torch/engine/cuda_ops.py:BatchStrides.
struct BatchStrides {
  long long slab, w, w2;
};

struct Group {
  Window win[kMaxWindows];
  BatchStrides bs[kMaxWindows];
};

// One block's tile of descriptor d for one batch element: slab, w0 / w1
// (w and w2) and out are that element's bases; kW = 2 when d carries w2.
template <int kW>
__device__ __forceinline__ void reduce_tile(
    const Window& d, const int* __restrict__ slab, const int* w0, const int* w1,
    int* __restrict__ out, int I, int J, int Q, int tt,
    int (&part)[2][kQGroups][kTileI][kTileJ]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ig = warp % kIGroups;
  const int qg = warp / kIGroups;
  const int j0 = blockIdx.x * kTileJ;
  const int i0 = blockIdx.y * kTileI;
  const int mode = d.mode;
  const int c = d.c_b + d.c_s * tt;
  int* const o[2] = {out + (long long)d.out * I * J, out + (long long)d.out2 * I * J};

  // The block's admissible q range [qa, qb]: the mask bound's largest value
  // over the tile (mode 1 at the tile's first j and last i, mode 2 at its
  // last j and first i).
  const int jl = min(j0 + kTileJ, J) - 1;
  const int il = min(i0 + kTileI, I) - 1;
  const int qa = max(d.q_lo, 0);
  int qb = Q - 1;
  if (mode == 1) {
    qb = min(qb, c - j0 + il);
  } else if (mode == 2) {
    qb = min(qb, jl - i0 - c);
  }
  if (qb < qa) {
    for (int t = threadIdx.x; t < kTileI * kTileJ; t += kThreads) {
      const int i = i0 + t / kTileJ, j = j0 + t % kTileJ;
      if (i < I && j < J) {
#pragma unroll
        for (int k = 0; k < kW; ++k) o[k][(long long)i * J + j] = kInf;
      }
    }
    return;
  }

  const int row0 = d.row0_b + d.row0_s * tt;
  const int scol = d.scol_b + d.scol_s * tt;
  const int wcol = d.wcol_b + d.wcol_s * tt;
  const int j = j0 + lane;
  const int jc = min(j, J - 1);                  // clamped: pointers stay inside
  const int ss0 = (int)d.ss0;
  const int* wp[2];                               // w[0, wcol + jc] and w2's
  const long long ws0[2] = {d.ws0, d.w2s0};
  wp[0] = w0 + (long long)(wcol + jc) * d.ws1;
  wp[1] = kW == 2 ? w1 + (long long)(wcol + jc) * d.w2s1 : nullptr;
  int hi[kRows], acc[kW][kRows], sp[kRows];       // sp: slab offset at q = 0
  int qmax = -1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + ig * kRows + r;
    int h = (j < J && i < I) ? qb : -1;
    if (mode == 1) {
      h = min(h, c - j + i);
    } else if (mode == 2) {
      h = min(h, j - i - c);
    }
    hi[r] = h;
    qmax = max(qmax, h);
#pragma unroll
    for (int k = 0; k < kW; ++k) acc[k][r] = kInf;
    sp[r] = (int)((long long)row0 * d.ss0 + (long long)min(i, I - 1) * d.ss1 +
                  (long long)(scol + jc) * d.ss2);
  }

  int q = qa + qg;
  for (; q + (kUnroll - 1) * kQGroups <= qmax; q += kUnroll * kQGroups) {
    int v[kUnroll][kRows];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int qq = q + u * kQGroups;
        v[u][r] = qq <= hi[r] ? __ldg(slab + (sp[r] + qq * ss0)) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int qq = q + u * kQGroups;
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        const int wv = __ldg(wp[k] + (long long)qq * ws0[k]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (qq <= hi[r]) acc[k][r] = min(acc[k][r], v[u][r] + wv);
        }
      }
    }
  }
  for (; q <= qmax; q += kQGroups) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (q <= hi[r]) {
        const int v = __ldg(slab + (sp[r] + q * ss0));
#pragma unroll
        for (int k = 0; k < kW; ++k) acc[k][r] = min(acc[k][r], v + __ldg(wp[k] + (long long)q * ws0[k]));
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kW; ++k) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[k][qg][ig * kRows + r][lane] = acc[k][r];
  }
  __syncthreads();
  if (warp < kTileI) {
    const int i = i0 + warp;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      int m = kInf;
#pragma unroll
      for (int g = 0; g < kQGroups; ++g) m = min(m, part[k][g][warp][lane]);
      if (i < I && j < J) o[k][(long long)i * J + j] = m;
    }
  }
}

// kBatched = false is the unbatched group (B = 1): no batch offsets at all.
template <bool kBatched>
__global__ void __launch_bounds__(kThreads)
minplus_group_kernel(const __grid_constant__ Group grp, int* __restrict__ out,
                     int D, int G, int I, int J, int Q, int tt) {
  __shared__ int part[2][kQGroups][kTileI][kTileJ];
  const int z = kBatched ? blockIdx.z % D : blockIdx.z;
  const Window& d = grp.win[z];
  const int* slab = d.slab;
  const int* w0 = d.w;
  const int* w1 = d.w2;
  int* o = out;
  if (kBatched) {
    const long long b = blockIdx.z / D;
    const BatchStrides& bs = grp.bs[z];
    slab += b * bs.slab;
    w0 += b * bs.w;
    if (w1 != nullptr) w1 += b * bs.w2;
    o += b * G * I * J;
  }
  if (w1 != nullptr) {
    reduce_tile<2>(d, slab, w0, w1, o, I, J, Q, tt, part);
  } else {
    reduce_tile<1>(d, slab, w0, nullptr, o, I, J, Q, tt, part);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_minplus_window_bytes() { return (int)sizeof(Window); }

extern "C" int ccj_minplus_batch_strides_bytes() { return (int)sizeof(BatchStrides); }

extern "C" int ccj_minplus_max_windows() { return kMaxWindows; }

// Reduce the D descriptors at `windows` (D consecutive Window structs, with
// D BatchStrides at `strides`) at `tt` for each of B batch elements into
// out [B, G, I, J] (int32, contiguous; each descriptor names its planes
// among the G) on `stream`.  Returns cudaGetLastError() after the launch:
// 0 on success.
extern "C" int ccj_minplus_group(const void* windows, const void* strides, int D,
                                 int B, int G, int tt, void* out, int I, int J,
                                 int Q, void* stream) {
  if (D < 1 || D > kMaxWindows || B < 1 || (long long)D * B > 65535)
    return (int)cudaErrorInvalidValue;
  if (I <= 0 || J <= 0) return 0;
  Group grp;
  std::memset(&grp, 0, sizeof(grp));
  std::memcpy(grp.win, windows, sizeof(Window) * D);
  std::memcpy(grp.bs, strides, sizeof(BatchStrides) * D);
  const dim3 grid((J + kTileJ - 1) / kTileJ, (I + kTileI - 1) / kTileI, D * B);
  if (B == 1) {
    minplus_group_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        grp, (int*)out, D, G, I, J, Q, tt);
  } else {
    minplus_group_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        grp, (int*)out, D, G, I, J, Q, tt);
  }
  return (int)cudaGetLastError();
}
