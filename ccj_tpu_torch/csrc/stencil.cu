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
// never counts; the kernel therefore stages only the outer offsets a tile
// of cells admits, d_outer <= min(29, G - 5) with G = j - i for PL and
// l - k = i + s - (j + tt + 2) for PR taken at the tile's largest, and
// takes the inner offsets from the weights alone.
//
// State reads.  The family is read in place, through at most two int16
// views [B, TTw, Uw, Rw, n2] into the state with a unit j stride (the dense
// layout's one block of the DS spans below s, the packed layout's two
// segments, a row shard's fetched halo), part p holding spans u0_p ..
// u0_p + Uw_p - 1 with its row 0 at i = i0.  A span no part holds (below
// 0), a tt row past a part's TTw, a row past its Rw and a column off
// [0, n2) read SAT16: those are values that take part (SAT16 + W can win
// where W < 0), never skipped terms.  All sums are plain int32: SAT16 + W
// stays far from overflow.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusions of
// the JAX package's PL and PR stencils, ccj_tpu/engine/gapped4.py:340-375
// (PL) and :392-414 (PR), ccj_tpu/engine/gapped5.py:403-452 (their packed
// windows), which the port ran as 2 x 29 eager passes a span over int32
// temporaries of up to [B, TB, 29, IB, n2] (cuda_ops.stencil_pl_ref /
// stencil_pr_ref, the plain versions).
//
// Bound: operations at the fills' large spans by the count of admissible
// terms, one add and one min each (one DPX __viaddmin_s32 on sm_90).  Most
// (d1, d2) are not admissible (at n=200 span 135 about 175 of 841 a cell:
// the weights are INF where the inner pair cannot pair, which depends on
// the sequence), so the design walks only the admissible ones, with no
// divergence; what holds it in practice is the staging of the planes from
// device memory, which it keeps in flight:
//
// * A warp's 32 lanes take 32 tt rows of one column, along which the
//   weight is constant: PL's W4PL[d1, d2, i, j] does not depend on tt, so
//   a column is j; PR's W4PR[d1, d2, u + 2, i + s] is constant along
//   u = j + tt, so a column is u and lane tt reads j = u - tt.
// * A block takes one (b, row i) and a tile of tt rows x 32 columns (x =
//   j - i for PL, x = u - i for PR): 128 tt rows for PL, 64 for PR (the
//   faster of the two for each on the H100).  Warp w takes columns w,
//   w + 8, w + 16, w + 24, each as the chunks of 32 tt rows that hold a
//   valid cell of that column; the rest are skipped.
// * Per outer offset d (d1 for PL, d2 for PR) the block stages the plane
//   it reads (PL's anti-diagonal, PR's diagonal in u: up to 156 or 92 tt
//   rows x 60 columns of int16, fewer for a tile at the triangle's edge)
//   and the 29 x 32 weights of its columns in shared memory.  For each of
//   its columns a warp reads the column's 29 inner weights, one lane an
//   inner offset (rows padded to 33 words: no bank conflict), turns them
//   into a mask with __ballot_sync(w < INF), and walks the set bits only
//   (__ffs), the weight broadcast by __shfl_sync: every lane runs the same
//   term, one shared int16 load and one DPX add-min a chunk.  A column
//   with no admissible inner offset costs one weight load and a ballot.
// * Staging is a 3-deep cp.async pipeline: the planes of the next two
//   outer offsets are in flight while this one's terms run, with no
//   registers held for them.  A plane row is copied as 4-byte words from
//   the word boundary below its first column (31 words, its 60 columns
//   from either parity; a staged row is 31 words, so the lanes' rows fall
//   on distinct banks), and the reader adds the row's parity.  Words with
//   no element in the view are written as SAT16, words with one at the
//   view's edge by two plain loads.
// * A span with few tiles (the n <= 100 fills, whose spans give a hundred
//   or two blocks) splits each tile's admissible outer offsets evenly over
//   up to 16 blocks, joined by atomicMin into the INF-filled output (a min:
//   any order gives the same result): at the smallest spans a block's
//   chain of dependent terms, not the card's width, sets the time.  Tiles outside the span's triangle of valid cells,
//   or with no admissible term (G < 6), exit at once.
//
// The lanes of a chunk past its column's last valid tt row compute terms
// that are never written: the walk takes 32 terms a set bit and chunk
// (chip_smoke.stencil_walked counts them).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kDS = 29;                 // gapped.DS: offsets 1..29
constexpr int kMaxParts = 2;            // cuda_ops.STENCIL_MAX_PARTS
constexpr int kSAT16 = 32767;
constexpr int kINF = 10000000;
constexpr int kTurn = 3;                // common.TURN
constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kTileX = 32;                         // columns a tile
constexpr int kColsPerWarp = kTileX / kWarps;      // 4
constexpr int kPlaneCols = kTileX + kDS - 1;       // 60 columns read
constexpr int kRowWords = kPlaneCols / 2 + 1;      // 31 words: 60 columns from any parity
constexpr int kPlaneStride = 2 * kRowWords;        // int16 a staged row
constexpr int kWStride = kTileX + 1;               // int32 a staged weight row
constexpr int kStages = 3;                         // planes in flight
constexpr unsigned kSAT16x2 = (unsigned)kSAT16 | ((unsigned)kSAT16 << 16);
static_assert(kRowWords % 2 == 1, "a staged row must be an odd number of words");

// A kind's tile: PL 4 chunks of 32 tt rows, PR 2.
template <int KIND>
struct Tile {
  static constexpr int kChunks = KIND == 0 ? 4 : 2;
  static constexpr int kRows = kChunks * kLanes;                 // tt rows
  static constexpr int kPlaneRows = kRows + kDS - 1;             // rows tt + d, d <= 29
  static constexpr int kStageWords = kPlaneRows * kRowWords + kDS * kWStride;
  static constexpr int kSmemBytes = kStages * kStageWords * 4;   // PL 69,516, PR 45,708
};

// One view of the family's state.  Mirrored field for field by
// ccj_tpu_torch/engine/cuda_ops.py:StencilPart.
struct StencilPart {
  const short* win;           // int16 [B, TTw, Uw, Rw, n2], unit j stride
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

__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The plane a block reads at outer offset d: span s - d of row i + d (PL)
// or i (PR), tt rows t0 + 1 on.  Staged row rr holds the 60 columns from
// c0 - g rr (g = 0 for PL, 1 for PR: its diagonal in u) from the word
// boundary below them: column c0 - g rr + cc lies at int16 rr * 62 +
// off(rr) + cc, off(rr) = (A + rr * dlt) & 1.
struct Plane {
  const short* row0;          // element (tt row t0 + 1, column c0), or null: SAT16
  int st1, TTw;               // tt stride; tt rows the view holds
  int A, dlt;                 // the parity of each staged row's first column
};

template <int KIND>
__device__ __forceinline__ Plane plane_of(const StencilTable& t, int d, int b, int r, int c0,
                                          int t0) {
  Plane P{nullptr, 0, 0, 0, 0};
  const int span = t.s - d;
  const int row = KIND == 0 ? r + d : r;
  for (int p = 0; p < t.nparts; ++p) {
    const StencilPart& V = t.part[p];
    if (span >= V.u0 && span < V.u0 + V.Uw && row < V.Rw) {
      P.st1 = (int)V.ws[1];             // a view spans < 2^31 elements (cuda_ops checks)
      P.TTw = V.TTw;
      P.row0 = V.win + b * V.ws[0] + (span - V.u0) * V.ws[2] + row * V.ws[3] +
               (long long)(t0 + 1) * P.st1 + c0;
    }
  }
  if (P.row0 != nullptr) {
    P.A = (int)(reinterpret_cast<uintptr_t>(P.row0) >> 1) & 1;
    P.dlt = (P.st1 - (KIND == 0 ? 0 : 1)) & 1;
  }
  return P;
}

// KIND 0: PL (outer d1, inner d2, column x = j - i);
// KIND 1: PR (outer d2, inner d1, column x = u - i, u = j + tt).
// Block (tile, part of the outer range, live row, batch element); three
// blocks an SM.
template <int KIND>
__global__ void __launch_bounds__(kThreads, 3)
stencil_kernel(const __grid_constant__ StencilTable t) {
  using T = Tile<KIND>;
  extern __shared__ __align__(16) unsigned smem[];   // kStages x (plane, weights)
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int b = blockIdx.z;
  const int i = t.lo + blockIdx.y;
  const int r = i - t.i0;
  const int s = t.s;
  const int tiles = t.ntx * t.nty;
  const int tile = blockIdx.x % tiles;
  const int x0 = (tile % t.ntx) * kTileX;
  const int t0 = (tile / t.ntx) * T::kRows;
  const int last_tt = min(t.TB, s - 1) - 1;
  // the tile's valid cells and the largest loop bound G among them
  int gmax;
  if (KIND == 0) {                    // 0 <= x <= s - 2 - tt
    if (t0 + x0 > s - 2) return;
    gmax = min(x0 + kTileX - 1, s - 2 - t0);
  } else {                            // tt <= x <= s - 2
    if (t0 > min(x0 + kTileX - 1, s - 2)) return;
    gmax = s - 2 - max(x0, t0);
  }
  // this block's share of the outer offsets 1 .. min(29, G - 5)
  const int d_max = min(kDS, gmax - kTurn - 2);
  const int chunk = (max(d_max, 1) + t.split - 1) / t.split;
  const int d_lo = 1 + (blockIdx.x / tiles) * chunk;
  const int d_hi = min(d_max, d_lo + chunk - 1);
  if (d_lo > d_hi) return;            // no admissible term: the cells stay INF
  // PL: row rr holds columns j - d_inner from i + x0 - 29; PR: the diagonal
  // j = u - tt, u + d1 - (tt + d1), from i + x0 - t0 - rr
  const int c0 = KIND == 0 ? i + x0 - kDS : i + x0 - t0;
  // the tile's last column and tt row with a valid cell: a tile at the
  // triangle's edge stages only the rows and words its live cells read
  const int x_hi = KIND == 0 ? min(x0 + kTileX - 1, s - 2 - t0) : min(x0 + kTileX - 1, s - 2);
  const int t_hi = min(min(last_tt, t0 + T::kRows - 1), KIND == 0 ? s - 2 - x0 : x_hi);
  const int nrows = t_hi - t0 + kDS;                     // <= kPlaneRows
  const int nwords = (x_hi - x0 + kDS) / 2 + 1;          // <= kRowWords
  const int ncols = x_hi - x0 + 1;                       // weight columns

  auto xs = [&](int q) { return smem + q * T::kStageWords; };
  auto ws = [&](int q) {
    return reinterpret_cast<int*>(smem + q * T::kStageWords + T::kPlaneRows * kRowWords);
  };
  // Stage the plane and the weights of outer offset d into buffer q.
  auto stage = [&](int d, int q) {
    const Plane P = plane_of<KIND>(t, d, b, r, c0, t0);
    unsigned* X = xs(q);
    for (int rr = warp; rr < nrows; rr += kWarps) {
      if (lane >= nwords) continue;
      unsigned* dst = X + rr * kRowWords + lane;
      const int off = (P.A + rr * P.dlt) & 1;
      const int col = c0 - (KIND == 0 ? 0 : rr) - off + 2 * lane;   // the word's first
      const bool row_ok = P.row0 != nullptr && t0 + 1 + rr < P.TTw;
      const bool lo_ok = row_ok && col >= 0 && col < t.n2;
      const bool hi_ok = row_ok && col + 1 >= 0 && col + 1 < t.n2;
      const short* src = row_ok ? P.row0 + (long long)rr * P.st1 + (col - c0) : nullptr;
      if (lo_ok && hi_ok) {
        copy4(dst, src);
      } else if (!lo_ok && !hi_ok) {
        *dst = kSAT16x2;
      } else {
        const unsigned lo = lo_ok ? (unsigned short)__ldg(src) : (unsigned)kSAT16;
        const unsigned hi = hi_ok ? (unsigned short)__ldg(src + 1) : (unsigned)kSAT16;
        *dst = lo | (hi << 16);
      }
    }
    int* W = ws(q);
    for (int e = threadIdx.x; e < kDS * kTileX; e += kThreads) {
      const int di = e / kTileX;                   // inner offset - 1
      const int ln = e % kTileX;
      if (ln >= ncols) continue;                   // no valid cell: never read
      const int* src = nullptr;
      if (KIND == 0) {                             // W4PL[b, d - 1, di, i, j]
        const int j = i + x0 + ln;
        if (j < t.n2)
          src = t.w + b * t.wst[0] + (d - 1) * t.wst[1] + di * t.wst[2] + i * t.wst[3] +
                j * t.wst[4];
      } else {                                     // W4PR[b, di, d - 1, u + 2, i + s]
        const int k = i + x0 + ln + 2;
        const int l = i + s;
        if (k < t.WK && l < t.WL)
          src = t.w + b * t.wst[0] + di * t.wst[1] + (d - 1) * t.wst[2] + k * t.wst[3] +
                l * t.wst[4];
      }
      if (src != nullptr)
        copy4(W + di * kWStride + ln, src);
      else
        W[di * kWStride + ln] = kINF;
    }
  };

  // the warp's columns: each one's live chunks
  int nk[kColsPerWarp];
#pragma unroll
  for (int m = 0; m < kColsPerWarp; ++m) {
    const int x = x0 + warp + kWarps * m;
    const int last = KIND == 0 ? min(last_tt, s - 2 - x) : (x > s - 2 ? -1 : min(last_tt, x));
    nk[m] = last < t0 ? 0 : min(T::kChunks, (last - t0) / kLanes + 1);
  }
  int acc[kColsPerWarp][T::kChunks];
#pragma unroll
  for (int m = 0; m < kColsPerWarp; ++m)
#pragma unroll
    for (int k = 0; k < T::kChunks; ++k) acc[m][k] = kINF;
  // Lane tt = t0 + 32 k + lane of column c, inner offset dd + 1, reads the
  // staged row 32 k + lane + dd at column c + 28 - dd (PL) or c + dd (PR):
  // one step of kStep int16 a set bit, and the row's parity.
  constexpr int kStep = KIND == 0 ? kPlaneStride - 1 : kPlaneStride + 1;

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (d_lo + p <= d_hi) stage(d_lo + p, p);
    commit();
  }
  for (int d = d_lo; d <= d_hi; ++d) {
    const int q = (d - d_lo) % kStages;
    wait_group<kStages - 2>();        // this thread's copies of plane d have landed
    __syncthreads();                  // everyone's; buffer q - 1 is read no more
    if (d + kStages - 1 <= d_hi) stage(d + kStages - 1, (q + kStages - 1) % kStages);
    commit();
    const Plane P = plane_of<KIND>(t, d, b, r, c0, t0);
    const int lp = (P.A + lane * P.dlt) & 1;      // parity of the lane's row at dd = 0
    const short* xq = reinterpret_cast<const short*>(xs(q));
    const int* wq = ws(q);
#pragma unroll
    for (int m = 0; m < kColsPerWarp; ++m) {
      if (nk[m] == 0) continue;       // the same for the whole warp
      const int c = warp + kWarps * m;
      const int w = lane < kDS ? wq[lane * kWStride + c] : kINF;
      unsigned mask = __ballot_sync(0xffffffffu, w < kINF);
      const short* X = xq + lane * kPlaneStride + (KIND == 0 ? c + kDS - 1 : c);
      while (mask) {
        const int dd = __ffs(mask) - 1;
        mask &= mask - 1;
        const int wv = __shfl_sync(0xffffffffu, w, dd);
        const short* p = X + dd * kStep + (lp ^ (dd & P.dlt));
#pragma unroll
        for (int k = 0; k < T::kChunks; ++k)
          if (k < nk[m]) acc[m][k] = add_min((int)p[k * kLanes * kPlaneStride], wv, acc[m][k]);
      }
    }
  }

  // ---- the warp's valid cells --------------------------------------------
#pragma unroll
  for (int m = 0; m < kColsPerWarp; ++m) {
    const int x = x0 + warp + kWarps * m;
    const int last = KIND == 0 ? min(last_tt, s - 2 - x) : min(last_tt, x);
#pragma unroll
    for (int k = 0; k < T::kChunks; ++k) {
      const int tt = t0 + k * kLanes + lane;
      if (k >= nk[m] || tt > last) continue;
      const int j = KIND == 0 ? i + x : i + x - tt;
      int* o = t.out + b * t.os[0] + tt * t.os[1] + r * t.os[2] + j * t.os[3];
      if (t.split == 1)
        *o = acc[m][k];
      else if (acc[m][k] < kINF)
        atomicMin(o, acc[m][k]);
    }
  }
}

template <int KIND>
int launch(StencilTable& t, int rows, int sms, cudaStream_t stream) {
  using T = Tile<KIND>;
  t.ntx = (t.s - 1 + kTileX - 1) / kTileX;
  t.nty = (rows + T::kRows - 1) / T::kRows;
  // a span with few tiles splits each tile's outer offsets over up to 16
  // blocks (joined by atomicMin into the INF-filled output), so that the
  // launch fills about four blocks an SM
  const long long blocks = (long long)t.ntx * t.nty * t.nlive * t.B;
  const long long want = (4LL * sms + blocks - 1) / blocks;
  t.split = (int)(want < 1 ? 1 : want > 16 ? 16 : want);
  // past 48 KB a block asks for its shared memory (on the current device)
  const cudaError_t e = cudaFuncSetAttribute(
      stencil_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(t.ntx * t.nty * t.split, t.nlive, t.B);
  stencil_kernel<KIND><<<grid, kThreads, T::kSmemBytes, stream>>>(t);
  return (int)cudaGetLastError();
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
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return t.kind == 0 ? launch<0>(t, rows, sms, (cudaStream_t)stream)
                     : launch<1>(t, rows, sms, (cudaStream_t)stream);
}
