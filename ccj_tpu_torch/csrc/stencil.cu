// stencil_pl / stencil_pr: the gapped step's two MAXLOOP^2 interior-loop
// stencils of one span, every live row and batch element in one launch
// each, hand-written for Hopper (sm_90a).
//
//   PL:  out[b, tt, r, j] = min over d1, d2 in [1, 29] of
//          PL[b, tt + d2, s - d1, i + d1, j - d2] + W4PL[b, d1 - 1, d2 - 1, i, j]
//   PR:  out[b, tt, r, j] = min over d1, d2 in [1, 29] of
//          PR[b, tt + d1, s - d2, i, j] + W4PR[b, d1 - 1, d2 - 1, j + tt + 2, i + s]
//
// (pseudo_loop.cc:682-703 and :717-738), row r being i = i0 + r.  Only the
// terms whose weight is below INF take part: the output is min(INF, that
// minimum) on the span's valid cells of its live rows (i >= 1, i + s <= n,
// j >= i, j + tt + 2 <= i + s) and INF elsewhere (the caller's output is
// filled with INF; the kernel writes the valid cells only).  The weights
// fold every loop bound of the reference and the inner pair's pairability
// in as INF (gapped4.build_sc4), so a term outside a cell's loop bounds
// never counts; the kernel therefore walks only the (d1, d2) ranges a tile
// of cells admits, d_outer <= min(29, G - 5) and d_inner <= min(29, G - 4 -
// d_outer), with G = j - i for PL and l - k = i + s - (j + tt + 2) for PR,
// taken at the tile's largest.
//
// State reads.  The family is read in place, through at most two int16
// strided views [B, TTw, Uw, Rw, n2] into the state (the dense layout's one
// block of the DS spans below s, the packed layout's two segments, a row
// shard's fetched halo), part p holding spans u0_p .. u0_p + Uw_p - 1 with
// its row 0 at i = i0.  A span no part holds (below 0), a tt row past a
// part's TTw and a row past its Rw read SAT16: those are values that take
// part (SAT16 + W can win where W < 0), never skipped terms.  All sums are
// plain int32: SAT16 + W stays far from overflow.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusions of
// the JAX package's PL and PR stencils, ccj_tpu/engine/gapped4.py:340-375
// (PL) and :392-414 (PR), ccj_tpu/engine/gapped5.py:403-452 (their packed
// windows), which the port ran as 2 x 29 eager passes a span over int32
// temporaries of up to [B, TB, 29, IB, n2] (cuda_ops.stencil_pl_ref /
// stencil_pr_ref, the plain versions).
//
// Bound: operations at the fills' large spans.  Each admissible term is
// one add and one min (one DPX __viaddmin_s32 on sm_90), and the terms
// outnumber the bytes: a window element feeds up to 29 terms, a weight up
// to the span's tt count.  Design: a block of 8 warps takes one (b, row i)
// and a tile of 64 tt rows x 32 columns x (j - i for PL; u - i, u = j + tt,
// for PR, where the weights are constant along u); lanes take the columns
// and each thread keeps the running minima of 8 tt rows in registers.  Per
// outer offset (d1 for PL, d2 for PR) the block stages the plane it reads,
// (64 + 28) x 60 int16 (PL's anti-diagonal, PR's diagonal in u), and the
// 29 x 32 weights of its columns in shared memory; each inner offset then
// costs one shared weight load and 8 shared int16 loads for 8 terms.  The
// staging is double-buffered: each thread's 23 plane and 4 weight loads of
// the next offset are in flight (in registers) while this offset's terms
// run, so a block waits on memory once, not 29 times.  A span with few
// tiles (the n <= 100 fills, whose spans give a hundred or two blocks)
// splits each tile's outer offsets over up to 8 blocks, joined by
// atomicMin into the INF-filled output (a min: any order gives the same
// result).  Tiles outside the span's triangle of valid cells, or with no
// admissible term (G < 6), exit at once.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kDS = 29;                 // gapped.DS: offsets 1..29
constexpr int kMaxParts = 2;            // cuda_ops.STENCIL_MAX_PARTS
constexpr int kSAT16 = 32767;
constexpr int kINF = 10000000;
constexpr int kSkip = kINF + 32768;     // a weight >= INF: its term never wins
constexpr int kTurn = 3;                // common.TURN
constexpr int kLanes = 32;              // tile columns
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kRowsPerThread = 8;
constexpr int kTileT = kWarps * kRowsPerThread;    // 64 tt rows a tile
constexpr int kPlaneRows = kTileT + kDS - 1;       // rows tt + d, d <= 29
constexpr int kPlaneCols = kLanes + kDS - 1;       // 60 columns read
constexpr int kPlaneStride = 64;                   // int16 a staged row

// One view of the family's state.  Mirrored field for field by
// ccj_tpu_torch/engine/cuda_ops.py:StencilPart.
struct StencilPart {
  const short* win;           // int16 [B, TTw, Uw, Rw, n2]
  long long ws[5];            // its element strides
  int TTw, Uw, Rw, u0;        // tt rows, spans, rows; span of u row 0
};

// Mirrored field for field by ccj_tpu_torch/engine/cuda_ops.py:StencilTable.
struct StencilTable {
  StencilPart part[kMaxParts];
  const int* w;               // int32 W4PL [B, DS, DS, >= i0 + R, n2] or
                              // W4PR [B, DS, DS, WK, WL]
  long long wst[5];
  int* out;                   // int32 [B, TB, R, n2], INF-filled by the caller
  long long os[4];
  int nparts, kind, B, TB, R, n2, s, i0, lo, nlive, WK, WL;
  int ntx, nty, split;        // tiles across and down, blocks a tile (the launch's)
};

__device__ __forceinline__ int add_min(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && (__CUDACC_VER_MAJOR__ >= 12)
  return __viaddmin_s32(a, b, c);       // min(a + b, c), one DPX instruction
#else
  return min(a + b, c);
#endif
}

// The plane and weights one thread stages per outer offset.
constexpr int kStageX = kPlaneRows * kPlaneStride / kThreads;      // 23
constexpr int kStageW = (kDS * kLanes + kThreads - 1) / kThreads;  // 4
static_assert(kStageX * kThreads == kPlaneRows * kPlaneStride, "plane split");

// KIND 0: PL (outer d1, inner d2, column x = j - i);
// KIND 1: PR (outer d2, inner d1, column x = u - i, u = j + tt).
// Block (tile, part of the outer range, live row, batch element).
// PL runs two blocks an SM (128 registers, a few bytes of spill); PR, whose
// skewed plane takes more registers to stage, one without spill: each the
// faster of the two on the H100.
template <int KIND>
__global__ void __launch_bounds__(kThreads, KIND == 0 ? 2 : 1)
stencil_kernel(const __grid_constant__ StencilTable t) {
  __shared__ short xs[2][kPlaneRows][kPlaneStride];
  __shared__ int ws[2][kDS][kLanes];
  const int lane = threadIdx.x & (kLanes - 1);
  const int ty = threadIdx.x / kLanes;
  const int b = blockIdx.z;
  const int i = t.lo + blockIdx.y;
  const int r = i - t.i0;
  const int s = t.s;
  const int tiles = t.ntx * t.nty;
  const int tile = blockIdx.x % tiles;
  const int x0 = (tile % t.ntx) * kLanes;
  const int t0 = (tile / t.ntx) * kTileT;
  const int last_tt = min(t.TB, s - 1) - 1;
  // the tile's valid cells and the largest loop bound G among them
  int gmax;
  if (KIND == 0) {                    // 0 <= x <= s - 2 - tt
    if (t0 + x0 > s - 2) return;
    gmax = min(x0 + kLanes - 1, s - 2 - t0);
  } else {                            // tt <= x <= s - 2
    if (t0 > min(x0 + kLanes - 1, s - 2)) return;
    gmax = s - 2 - max(x0, t0);
  }
  // this block's share of the outer offsets 1 .. min(29, G - 5)
  const int chunk = (kDS + t.split - 1) / t.split;
  const int d_lo = 1 + (blockIdx.x / tiles) * chunk;
  const int d_hi = min(min(kDS, gmax - kTurn - 2), d_lo + chunk - 1);
  if (d_lo > d_hi) return;            // no admissible term: the cells stay INF

  short xr[kStageX];
  int wr[kStageW];
  // the plane at span s - d (PL: row i + d; PR: row i) and the weights of
  // the tile's columns at outer offset d, into registers
  auto load = [&](int d) {
    const int span = s - d;
    const int row = KIND == 0 ? r + d : r;
    const short* base = nullptr;
    int st1 = 0, st4 = 0;             // a view spans < 2^31 elements (cuda_ops checks)
    int TTw = 0;
    for (int p = 0; p < t.nparts; ++p) {
      const StencilPart& P = t.part[p];
      if (span >= P.u0 && span < P.u0 + P.Uw && row < P.Rw) {
        base = P.win + b * P.ws[0] + (span - P.u0) * P.ws[2] + row * P.ws[3];
        st1 = (int)P.ws[1];
        st4 = (int)P.ws[4];
        TTw = P.TTw;
      }
    }
#pragma unroll
    for (int q = 0; q < kStageX; ++q) {
      const int e = q * kThreads + threadIdx.x;
      const int rr = e / kPlaneStride;
      const int cc = e % kPlaneStride;
      const int tg = t0 + 1 + rr;                  // tt + d_inner of the row
      // PL: column j - d_inner; PR: column j = (u + d1) - (tt + d1)
      const int col = KIND == 0 ? i + x0 - kDS + cc : i + x0 - t0 + cc - rr;
      xr[q] = (base != nullptr && tg < TTw && col >= 0 && col < t.n2)
                  ? __ldg(base + tg * st1 + col * st4) : (short)kSAT16;
    }
#pragma unroll
    for (int q = 0; q < kStageW; ++q) {
      const int e = q * kThreads + threadIdx.x;
      const int di = e / kLanes;                   // inner offset - 1
      const int ln = e % kLanes;
      int w = kINF;
      if (di < kDS) {
        if (KIND == 0) {                           // W4PL[b, d - 1, di, i, j]
          const int j = i + x0 + ln;
          if (j < t.n2)
            w = __ldg(t.w + b * t.wst[0] + (d - 1) * t.wst[1] + di * t.wst[2] +
                      i * t.wst[3] + j * t.wst[4]);
        } else {                                   // W4PR[b, di, d - 1, u + 2, i + s]
          const int k = i + x0 + ln + 2;
          const int l = i + s;
          if (k < t.WK && l < t.WL)
            w = __ldg(t.w + b * t.wst[0] + di * t.wst[1] + (d - 1) * t.wst[2] +
                      k * t.wst[3] + l * t.wst[4]);
        }
      }
      wr[q] = w >= kINF ? kSkip : w;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kStageX; ++q) {
      const int e = q * kThreads + threadIdx.x;
      xs[buf][e / kPlaneStride][e % kPlaneStride] = xr[q];
    }
#pragma unroll
    for (int q = 0; q < kStageW; ++q) {
      const int e = q * kThreads + threadIdx.x;
      if (e < kDS * kLanes) ws[buf][e / kLanes][e % kLanes] = wr[q];
    }
  };

  int acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) acc[k] = kINF;
  const int tl = ty * kRowsPerThread;             // the thread's first tile row

  load(d_lo);
  store(0);
  __syncthreads();
  for (int d = d_lo; d <= d_hi; ++d) {
    const int buf = (d - d_lo) & 1;
    if (d < d_hi) load(d + 1);        // in flight while this plane's terms run
    const int imax = min(kDS, gmax - kTurn - 1 - d);
    for (int di = 1; di <= imax; ++di) {
      const int w = ws[buf][di - 1][lane];
      const int c = KIND == 0 ? lane + kDS - di : lane + di - 1;
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k)
        acc[k] = add_min((int)xs[buf][tl + k + di - 1][c], w, acc[k]);
    }
    // the other buffer was last read before the previous barrier
    if (d < d_hi) store(buf ^ 1);
    __syncthreads();
  }

  // ---- the tile's valid cells ----------------------------------------------
  const int x = x0 + lane;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int tt = t0 + tl + k;
    if (tt > last_tt) break;
    int j;
    if (KIND == 0) {
      if (x > s - 2 - tt) continue;
      j = i + x;
    } else {
      if (x < tt || x > s - 2) continue;
      j = i + x - tt;
    }
    int* o = t.out + b * t.os[0] + tt * t.os[1] + r * t.os[2] + j * t.os[3];
    if (t.split == 1)
      *o = acc[k];
    else if (acc[k] < kINF)
      atomicMin(o, acc[k]);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).

extern "C" int ccj_stencil_table_bytes() { return (int)sizeof(StencilTable); }

extern "C" int ccj_stencil_max_parts() { return kMaxParts; }

extern "C" int ccj_stencil_ds() { return kDS; }

// One stencil (the table's kind: 0 PL, 1 PR) over the live rows of
// `table` (one StencilTable), on `stream`.  Returns cudaGetLastError()
// after the launch: 0 on success.
extern "C" int ccj_stencil(const void* table, void* stream) {
  StencilTable t;
  std::memcpy(&t, table, sizeof(t));
  if (t.nparts < 0 || t.nparts > kMaxParts || t.B < 1 || t.B > 65535 ||
      t.nlive < 0 || t.nlive > 65535 || t.TB < 1 || t.R < 1 || t.n2 < 1 ||
      (t.kind != 0 && t.kind != 1))
    return (int)cudaErrorInvalidValue;
  const int cols = t.s - 1;                          // columns x in [0, s - 2]
  const int rows = t.TB < cols ? t.TB : cols;        // tt in [0, min(TB, s - 1))
  if (t.nlive == 0 || cols < 1) return 0;
  t.ntx = (cols + kLanes - 1) / kLanes;
  t.nty = (rows + kTileT - 1) / kTileT;
  // a span with few tiles splits each tile's outer offsets over up to 8
  // blocks (joined by atomicMin into the INF-filled output), so that the
  // launch fills about four blocks an SM
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (long long)t.ntx * t.nty * t.nlive * t.B;
  const long long want = (4LL * sms + blocks - 1) / blocks;
  t.split = (int)(want < 1 ? 1 : want > 8 ? 8 : want);
  const dim3 grid(t.ntx * t.nty * t.split, t.nlive, t.B);
  if (t.kind == 0)
    stencil_kernel<0><<<grid, kThreads, 0, (cudaStream_t)stream>>>(t);
  else
    stencil_kernel<1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
