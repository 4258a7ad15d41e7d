// Semiglobal-matching path traversals for Hopper (sm_90a).
//
// Replaces, in stereomatch_tpu/ops/sgm_pallas.py:
//   _sweep_kernel (K2, entered through _sweep_pass): the vertical and both
//     diagonal families, forward and reverse  -> sgm_rows_kernel;
//   _hsweep_kernel_natural (K3, entered through _hsweep_pass_natural): the
//     horizontal family, forward and reverse  -> sgm_horizontal_kernel;
//   _chunk_kernel (K5, entered through sweep_chunk_with_carry) and its
//     W-on-grid form _chunk_kernel_wgrid (K6): one row traversal over a
//     chunk of rows that starts from the carry of the row before the chunk
//     and emits the carry of its last row, the exact cross-tile hand-off
//     of the row-sharded pipeline  -> sgm_chunk_kernel.
// All three kernels walk straight pixel paths, the design of the reference's
// semiglobal_gpu.cu: one warp per path, the [D] carry in registers (lane l
// holds d = l*VPL .. l*VPL+VPL-1), min over D by warp shuffles, and out (+)= L
// in place.  They share one walk (ring_path): a ring of asynchronous copies
// that brings each step's operands into shared memory ahead of the
// recurrence (warp_min, p2_of, advance); the chunk kernel adds the carry
// hand-off at a path's first and last step.  The TPU kernels' W-on-grid
// layouts, zero-row padding and transposed P2 maps were VMEM workarounds and
// have no counterpart here.
//
// Semantics (plain version: stereomatch_tpu_torch/ops/aggregation.py, the
// XLA scan's association, stereomatch_tpu/ops/aggregation.py:107-138):
//   at a path start (its predecessor lies outside the image): L = C;
//   elsewhere, with prev = L at the predecessor and m = min_d prev:
//     P2' = max(P1, P2 / |I(p) - I(pred)|)      (|dI| = 0 gives +inf)
//       or, where the launch's `adaptive` is 0 (the constant form of
//       Hirschmuller's SGM, the port's own), P2' = max(P1, P2)
//     n   = prev - m
//     L   = C + min(n[d], n[d-1] + P1, n[d+1] + P1, P2')  (+inf off-band)
// Every operation is one IEEE-rounded sub/add/div (explicit _rn
// intrinsics, -fmad=false) or an exact min/max that lets NaN through like
// jnp.minimum/torch.minimum, so L equals the plain version bit for bit.
// The sum over the traversals is formed in the plain version's order, in
// one of two launch structures (ops/sgm_cuda.py picks one by the shape;
// the traversals' steps come from TRAVERSALS there):
//   serial: one launch per traversal, in order, each adding its L onto out
//     in place (sgm_rows_kernel, sgm_horizontal_kernel);
//   side by side: sgm_side_by_side_kernel walks the first seven traversals
//     at once, traversal 0 writing its L into out and traversal t > 0 its
//     L, P_t, into partial volume t - 1; sgm_fold_kernel walks the last and
//     forms ((out + P_1) + ... + P_6) + L, each addition rounded on its
//     own.  No traversal reads another's L, so that order is all that ties
//     them, and both structures make the same IEEE operations in the same
//     order.
//
// The chunk kernel (plain version: ops/aggregation.py::
// sweep_chunk_with_carry): a path that enters through the chunk's first
// row in scan order continues the path of its predecessor pixel
// (y - dy, x - dx) in the row before the chunk: its first step takes
// prev = carry[x - dx] and the intensity carry_image[x - dx] instead of
// L = C.  Where x - dx falls outside [0, W) (the diagonal's entry column)
// or seed is set (the first chunk in scan order) it starts with L = C, and
// so does every path that enters through the side column.  Each path whose
// last pixel lies on the chunk's last row in scan order writes its L there
// into carry_out[x]; every column of that row ends exactly one path.  The
// TPU kernel fused the three row families into one [F, W, D] carry to save
// VMEM passes; here one launch covers one traversal of one chunk, and its
// [W, D] carry is read once and written once.
//
// What bounds it on an H100: the recurrence is sequential along a path: a
// step's min over D (five shuffle rounds, each feeding a NaN-aware min) and
// band are a chain of dependent shuffles and selects, about 0.3 us a step
// (PERF.md), and a traversal has only W, H or W+H-1 paths (375-824 warps at
// teddy, at most a fifth of the card's 132 x 32 one-warp block slots), so in
// the serial structure nothing else hides that latency: each launch lasts
// its longest path's step chain.  A step's cost and out rows come from
// device memory, about a microsecond away under load; fetched one step
// ahead, that round trip would add to every step.  So each warp keeps a ring
// of kRingStages (8) steps in shared memory (ring_path): at step s the warp
// takes stage s, starts cp.async copies of step s + 7 and runs the
// recurrence, so the loads of 7 steps are in flight behind it, and P2' (a
// division) is computed 32 steps at a time off the chain.  The side-by-side
// structure puts seven traversals' paths on the card at once (4,122 warps
// at teddy), so their step chains overlap and the walk is bound by bytes:
// the same 23 volume passes as the serial structure (14 in the side-by-side
// launch, 9 in the fold, whose ring stages carry eight rows a step), plus
// six volumes of scratch, which ops/sgm_cuda.py bounds at 4 GiB.  Where
// nothing reads the summed volume (a plain winner-takes-all frame), the
// fold's winner-takes-all form (sgm_fold_wta_kernel) writes each pixel's
// int32 argmin in place of its row: 22 volume passes a frame, and no
// argmin pass after them.  Past that
// bound, at HD D = 256 (1280-2303 warps), one traversal already fills the
// card, the serial structure is bound by the bytes of its launches, three
// volumes a traversal, and it is the faster.  One-warp blocks spread the
// paths over all 132 SMs.  The chunk kernel's W or W+Hc-1 warps walk paths
// of at most Hc steps (75 at teddy in 5 row tiles): the same latency bound
// over fewer steps, paid once per chunk in launch and ramp-up; a chunk
// shorter than the ring only fetches fewer live steps.
//
// bfloat16 storage (the JAX package's bf16 volumes; its XLA scan widens the
// cost to float32 once, sums the eight traversals in float32 and rounds the
// sum to bf16 once, ops/aggregation.py:211,226): the same kernels read a
// bf16 cost volume (T = __nv_bfloat16) and widen each value as the warp
// takes it from the ring; the recurrence, the carries and the partial sum
// `out` stay float32.  The launch of the last traversal (FINAL) adds its L
// onto `out` as every accumulating launch does and stores that sum rounded
// to nearest even into the bf16 `result` instead of writing it back, so
// the sum is rounded once and no extra pass casts it.  A bf16 row may
// start at any 2-byte boundary (odd D, a view at an odd element offset),
// and cp.async copies no fewer than 4 bytes: the warp copies the aligned
// 16-byte pieces that hold the row's D values and reads them at the row's
// offset into its first piece (bf16.cuh's copy_row_pieces).  The ring's
// bf16 cost slots take half the float32 ones' bytes plus one piece; out is
// read and written as before.
//
// Winner-takes-all in the fold (WTA): as the warp forms a pixel's final sum
// (bf16: rounded as `result` would hold it), it takes the index
// torch.argmin(sum, dim=2) gives, in int32: the first NaN, else the first
// least value, -0.0 equal to +0.0, so an all-+inf row gives 0.  Each lane
// keys its values in that order (wta_key) and keeps its first least; one
// redux.sync finds the warp's least key and a ballot the lowest lane that
// holds it, which stores its index.  None of it feeds the recurrence.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "cp_async.cuh"

namespace {

using stm::commit_copies;
using stm::copy16;
using stm::copy4;
using stm::wait_copies;

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// min / max that return NaN when either operand is NaN (jnp.minimum).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Path {
  int y, x, len;
};

// Start pixel and length of path `i` of the traversal with step (dy, dx).
// Starts: the row the step enters through (when dy != 0), then the column
// it enters through (when dx != 0), without the corner twice.
__device__ __forceinline__ Path path_of(int i, int H, int W, int dy,
                                        int dx) {
  const int y0 = dy > 0 ? 0 : H - 1;
  const int x0 = dx > 0 ? 0 : W - 1;
  const int row_starts = dy != 0 ? W : 0;
  Path p;
  if (i < row_starts) {
    p.y = y0;
    p.x = i;
  } else {
    const int j = i - row_starts;
    p.y = dy != 0 ? y0 + dy * (j + 1) : j;
    p.x = x0;
  }
  int len = 1 << 30;
  if (dy > 0) len = min(len, H - p.y);
  if (dy < 0) len = min(len, p.y + 1);
  if (dx > 0) len = min(len, W - p.x);
  if (dx < 0) len = min(len, p.x + 1);
  p.len = len;
  return p;
}

__host__ __device__ __forceinline__ int path_count(int H, int W, int dy,
                                                   int dx) {
  if (dy == 0) return H;
  if (dx == 0) return W;
  return W + H - 1;
}

// The recurrence, in three parts: m = min_d prev over the warp, P2' from
// the two intensities, and L from m, P2' and the costs c.

// A value's place in torch.argmin's order as an unsigned key, least
// first: NaN 0, then the numbers in increasing order from 1, with -0.0
// taken as +0.0.  The largest key of a number, +inf's, is 0xff800001, so
// 0xffffffff (a lane past D) never wins.
__device__ __forceinline__ unsigned wta_key(float x) {
  if (x != x) return 0u;
  unsigned u = __float_as_uint(x);
  if ((u << 1) == 0u) u = 0u;  // -0.0 ties +0.0
  return ((u & 0x80000000u) ? ~u : (u | 0x80000000u)) + 1u;
}

template <int VPL>
__device__ __forceinline__ float warp_min(const float (&prev)[VPL]) {
  float m = prev[0];
#pragma unroll
  for (int j = 1; j < VPL; ++j) m = nan_min(m, prev[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_min(m, __shfl_xor_sync(kFullMask, m, off));
  }
  return m;
}

// P2' of a step: adaptive, max(P1, P2 / |dI|); else max(P1, P2).  A
// launch's `adaptive` is one value for every warp, and P2' is computed a
// block of 32 steps at a time off the step chain (ring_path's block_p2).
__device__ __forceinline__ float p2_of(float intensity, float prev_int,
                                       float p1, float p2, bool adaptive) {
  if (!adaptive) return nan_max(p1, p2);
  const float grad = fabsf(__fsub_rn(intensity, prev_int));
  return nan_max(p1, __fdiv_rn(p2, grad));
}

template <int VPL>
__device__ __forceinline__ void advance(float (&L)[VPL],
                                        const float (&c)[VPL],
                                        const float (&prev)[VPL], float m,
                                        float p2_adj, int lane, int D,
                                        float p1) {
  const int d0 = lane * VPL;
  float n[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) n[j] = __fsub_rn(prev[j], m);
  float from_left = __shfl_up_sync(kFullMask, n[VPL - 1], 1);
  float from_right = __shfl_down_sync(kFullMask, n[0], 1);
  if (lane == 0) from_left = inf_f();
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int d = d0 + j;
    const float up = j > 0 ? n[j - 1] : from_left;         // d - 1
    float down = j + 1 < VPL ? n[j + 1] : from_right;       // d + 1
    if (d + 1 >= D) down = inf_f();
    const float band =
        nan_min(nan_min(n[j], __fadd_rn(up, p1)),
                nan_min(__fadd_rn(down, p1), p2_adj));
    L[j] = __fadd_rn(c[j], band);
  }
}

// Hand-off buffers of the chunk kernel: the carry [W, D] and intensities
// [W] of the row before the chunk in scan order (unread when seed is
// set), and the carry [W, D] of the chunk's last row (none when null).
// The whole-image kernels take kNoCarry.
struct Carry {
  const float* in;
  const float* image;
  float* out;
  bool seed;
};
constexpr Carry kNoCarry{nullptr, nullptr, nullptr, true};

// The partial volumes the folding launch adds in (sgm_fold_kernel): NF
// float32 volumes of `plane` elements each, back to back from `partials`.
// The other kernels take none (Fold{}).
struct Fold {
  const float* partials = nullptr;
  long plane = 0;
};

// The side-by-side launch walks the first kSideBySide traversals of
// TRAVERSALS (ops/aggregation.py) at once, each into a volume of its own;
// the folding launch walks the last and adds the kFolded partial volumes
// of traversals 1 .. kSideBySide - 1 in order.
constexpr int kSideBySide = 7;
constexpr int kFolded = kSideBySide - 1;

// The ring's depth and the warps of a block.  Of 4, 8 and 16 stages and
// 1, 2 and 4 warps, measured at teddy (VPL 4) and HD (VPL 8) on an H100
// (PERF.md), 8 stages and one warp were the best or within noise of it at
// both: 7 steps ahead keep about 3 MB in flight over teddy's 375-824
// warps, and one-warp blocks spread them over every SM.
constexpr int kRingStages = 8;
constexpr int kRingWarpsPerBlock = 1;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// Bytes of one step's cost slot: float32, the row as the warp reads it,
// 32 * VPL floats in d order; bf16, the 16-byte pieces that hold a row of
// 32 * VPL values (bf16.cuh; with VEC every row starts a piece).
template <typename T, int VPL, bool VEC>
constexpr int kCostSlotBytes =
    kIsF32<T> ? 4 * 32 * VPL : stm::kRowSlotBytes<32 * VPL, VEC>;

// Bytes of one warp's ring: per stage the cost slot, then (when
// accumulating) the float32 out row and the NF partial rows folded into
// it, each 32 * VPL floats in d order.
template <typename T, int VPL, bool VEC, bool ACC, int NF = 0>
constexpr int kRingBytes =
    kRingStages *
    (kCostSlotBytes<T, VPL, VEC> + (ACC ? (1 + NF) * 4 * 32 * VPL : 0));

// The walk of all three kernels: a ring of S = kRingStages steps in shared
// memory, filled by cp.async S - 1 steps ahead of the recurrence.
//
// The warp copies a step's cost row (and out row) in coalesced pieces,
// 16 bytes a lane (VEC) or 4, so a lane reads back values that other
// lanes copied: each lane waits for its own copies, then __syncwarp
// publishes them to the warp.  Every step issues the same copies as
// predicated instructions, without a branch: a piece past D, or of a step
// past the path's end, is not copied.  The ring's entries past D hold
// +inf (cost) and 0 (out), written once by the lane that reads them, so
// lanes past D read those and never a copied value.  Each step commits
// one group, so at step s exactly S - 1 + s groups are committed, and
// waiting until at most S - 2 are pending means step s's group has
// landed.  The copies of step s + S - 1, issued at step s after its wait,
// go to the slot of step s - 1, which every lane finished reading before
// the __syncwarp of step s.  Issuing them before the recurrence, in one
// basic block with it, lets the compiler place them in the stalls of its
// shuffle chain.
//
// A bf16 cost row (T = __nv_bfloat16) is copied as the aligned 16-byte
// pieces that hold it, whatever its alignment, and read at its offset into
// the first piece (bf16.cuh's copy_row_pieces and row_lead); with VEC
// every row starts a piece, and a lane reads its
// VPL values in one load of 8 or 16 bytes.  A lane past D takes +inf in
// place of what it reads.
//
// Fetching out S - 1 steps early is safe because each pixel lies on
// exactly one path of a launch: a launch is one traversal of the image or
// of one chunk of rows (path_of over the chunk's H rows), so no path
// writes a pixel that another path reads, and a path writes a pixel only
// at the step that reads it.  The carry a chunk reads and the one it
// writes are other buffers than cost and out.  Without ACC, out is not
// fetched at all.  With FINAL (bf16, ACC), out is read but not written:
// the sums go to `result`, rounded to bf16.
//
// Carry: the chunk kernel's hand-off (at the top of this file).  Step 0
// of a path that continues the carry runs the recurrence from carry.in,
// with carry.image as the intensity before it (lane 0's `before` in the
// first block of P2'); a path that ends on the chunk's last row in scan
// order writes its L into carry.out.  The whole-image kernels pass
// kNoCarry.
//
// Fold (NF > 0, the folding launch): each stage also holds the rows of
// the NF partial volumes at the step's pixel, and take adds them onto the
// out row in order, each with its own rounding and independent of the
// recurrence; store then adds L last.  So out + P_1 + ... + P_NF + L is
// formed in the order that NF + 1 accumulating launches form it.
// The partials are only read, at the pixel the step reads, so fetching
// them S - 1 steps early is safe as fetching out is.
//
// WTA (the folding launch's winner-takes-all form): store writes no row;
// it forms the sums as above and stores, at the step's pixel, the index of
// their least value into disparity [H, W] (the header of this file).
//
// P2' leaves the step chain: lane k computes it for step t0 + k of each
// block of 32 steps from intensities loaded a block ahead, and step t
// takes it by one shuffle, so the division runs once per 32 steps.  The
// operations and their operands are those of p2_of.
//
// VEC: 16-byte copies and stores, for VPL % 4 == 0, D % 4 == 0 and
// 16-byte-aligned out and cost (four floats lie wholly inside or past D;
// bf16 also needs D % 8 == 0, so that every row starts on a 16-byte
// boundary), and 8-byte stores of four bf16 sums into an 8-byte-aligned
// result; otherwise 4-byte copies and element stores.
template <typename T, int VPL, bool VEC, bool ACC, bool FINAL, int NF = 0,
          bool WTA = false>
__device__ void ring_path(const T* __restrict__ cost,
                          const float* __restrict__ image,
                          float* __restrict__ out,
                          __nv_bfloat16* __restrict__ result, int H, int W,
                          int D, int dy, int dx, float p1, float p2,
                          bool adaptive, int path, const Carry& carry,
                          const Fold& fold, unsigned char* ring,
                          int* __restrict__ disparity = nullptr) {
  static_assert(kRingStages >= 4 && (kRingStages & (kRingStages - 1)) == 0,
                "kRingStages is a power of two of at least 4");
  static_assert(!VEC || VPL % 4 == 0, "16-byte pieces need VPL % 4 == 0");
  static_assert(!FINAL || (ACC && !kIsF32<T>),
                "a final launch rounds a bf16 volume's accumulated sum");
  static_assert(NF == 0 || ACC, "partials are folded into an out row");
  static_assert(!WTA || (NF > 0 && !FINAL),
                "winner-takes-all takes the folding launch's final sums");
  constexpr int kRow = 32 * VPL;
  constexpr int kPiece = VEC ? 4 : 1;           // floats a copy moves
  constexpr int kPieces = VPL / kPiece;         // copies a lane a row
  constexpr int kSlot = kCostSlotBytes<T, VPL, VEC>;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * VPL;
  const Path p = path_of(path, H, W, dy, dx);
  const long step_pix = static_cast<long>(dy) * W + dx;
  const long first_pix = static_cast<long>(p.y) * W + p.x;
  const long step = step_pix * D;  // in elements
  const long first = first_pix * D;
  float* const cost_ring = reinterpret_cast<float*>(ring);
  float* const out_ring =
      reinterpret_cast<float*>(ring + kRingStages * kSlot);
  // Stage s's partial row k at fold_ring + (s * NF + k) * kRow.
  float* const fold_ring = out_ring + kRingStages * kRow;
  // Piece i of a row starts at float e[i]; in[i]: it lies inside D.
  int e[kPieces];
  bool in[kPieces];
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    e[i] = i * 32 * kPiece + kPiece * lane;
    in[i] = e[i] < D;
  }
  // The ring's entries past D, for every stage.
#pragma unroll 1
  for (int slot = 0; slot < kRingStages; ++slot) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (d0 + j >= D) {
        if constexpr (kIsF32<T>) cost_ring[slot * kRow + d0 + j] = inf_f();
        if constexpr (ACC) out_ring[slot * kRow + d0 + j] = 0.0f;
#pragma unroll
        for (int k = 0; k < NF; ++k) {
          fold_ring[(slot * NF + k) * kRow + d0 + j] = 0.0f;
        }
      }
    }
  }
  // The copies of steps t = 0, 1, ... in turn into their stages; `ahead`
  // is the next step's first element.
  int fetched = 0;
  long ahead = first;
  auto fetch = [&]() {
    const bool live = fetched < p.len;
    const int slot = fetched & (kRingStages - 1);
    const float* const osrc = out + ahead;
    if constexpr (kIsF32<T>) {
      const float* const src = cost + ahead;
#pragma unroll
      for (int i = 0; i < kPieces; ++i) {
        float* const dst = cost_ring + slot * kRow + e[i];
        if constexpr (VEC) {
          copy16(dst, src + e[i], live && in[i]);
        } else {
          copy4(dst, src + e[i], live && in[i]);
        }
      }
    } else {
      stm::copy_row_pieces<kSlot>(ring + slot * kSlot, cost + ahead, D, live,
                                  lane);
    }
    if constexpr (ACC) {
#pragma unroll
      for (int i = 0; i < kPieces; ++i) {
        float* const odst = out_ring + slot * kRow + e[i];
        if constexpr (VEC) {
          copy16(odst, osrc + e[i], live && in[i]);
        } else {
          copy4(odst, osrc + e[i], live && in[i]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const float* const fsrc = fold.partials + k * fold.plane + ahead;
#pragma unroll
      for (int i = 0; i < kPieces; ++i) {
        float* const fdst = fold_ring + (slot * NF + k) * kRow + e[i];
        if constexpr (VEC) {
          copy16(fdst, fsrc + e[i], live && in[i]);
        } else {
          copy4(fdst, fsrc + e[i], live && in[i]);
        }
      }
    }
    commit_copies();
    ++fetched;
    ahead += step;
  };
  // Intensities of steps [t0, t0 + 32), lane k holding step t0 + k.
  auto intensities = [&](int t0) {
    const int t = t0 + lane;
    return t < p.len ? image[first_pix + t * step_pix] : 0.0f;
  };
  // Step t's costs and out values from its stage, once it has landed.
  auto take = [&](int t, float (&c)[VPL], float (&o)[VPL]) {
    wait_copies<kRingStages - 2>();
    __syncwarp();
    const int slot = t & (kRingStages - 1);
    if constexpr (kIsF32<T>) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) c[j] = cost_ring[slot * kRow + d0 + j];
    } else if constexpr (VEC) {
      float v[VPL];
      stm::widen_aligned<VPL>(
          reinterpret_cast<const __nv_bfloat16*>(ring + slot * kSlot) + d0,
          v);
#pragma unroll
      for (int j = 0; j < VPL; ++j) c[j] = d0 + j < D ? v[j] : inf_f();
    } else {
      const int lead = stm::row_lead(cost + first + t * step);
      const __nv_bfloat16* const src =
          reinterpret_cast<const __nv_bfloat16*>(ring + slot * kSlot +
                                                 lead) + d0;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        c[j] = d0 + j < D ? __bfloat162float(src[j]) : inf_f();
      }
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      o[j] = ACC ? out_ring[slot * kRow + d0 + j] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NF; ++k) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        o[j] = __fadd_rn(o[j], fold_ring[(slot * NF + k) * kRow + d0 + j]);
      }
    }
  };
  // out (+)= L at element `at` of the volume, pixel `pix` (FINAL: result =
  // bf16(out + L); WTA: disparity[pix] = the argmin of out + L); prev
  // takes L (+inf past D).
  auto store = [&](long at, long pix, const float (&o)[VPL],
                   const float (&L)[VPL], float (&prev)[VPL]) {
    float v[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      v[j] = ACC ? __fadd_rn(o[j], L[j]) : L[j];
      prev[j] = d0 + j < D ? L[j] : inf_f();
    }
    if constexpr (WTA) {
      unsigned best = 0xffffffffu;
      int arg = 0;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float x = v[j];
        if constexpr (!kIsF32<T>) {
          x = __bfloat162float(__float2bfloat16_rn(x));
        }
        const unsigned key = d0 + j < D ? wta_key(x) : 0xffffffffu;
        if (key < best) {
          best = key;
          arg = j;
        }
      }
      const unsigned least = __reduce_min_sync(kFullMask, best);
      const unsigned holders = __ballot_sync(kFullMask, best == least);
      if (lane == __ffs(holders) - 1) disparity[pix] = d0 + arg;
    } else if constexpr (FINAL) {
      __nv_bfloat16* const dst = result + at + d0;
#pragma unroll
      for (int q = 0; q < VPL; q += kPiece) {
        if (d0 + q < D) {
          if constexpr (VEC) {
            *reinterpret_cast<uint2*>(dst + q) =
                stm::narrow4(v[q], v[q + 1], v[q + 2], v[q + 3]);
          } else {
            dst[q] = __float2bfloat16_rn(v[q]);
          }
        }
      }
    } else {
      float* const dst = out + at + d0;
#pragma unroll
      for (int q = 0; q < VPL; q += kPiece) {
        if (d0 + q < D) {
          if constexpr (VEC) {
            *reinterpret_cast<float4*>(dst + q) =
                make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
          } else {
            dst[q] = v[q];
          }
        }
      }
    }
  };

#pragma unroll 1
  for (int t = 0; t < kRingStages - 1; ++t) fetch();

  // P2' of the block of steps [t0, t0 + 32), lane k for step t0 + k; the
  // intensities of the next block are loaded as this one starts.
  float block_int = intensities(0);
  float next_int = intensities(32);
  float last_int = 0.0f;  // the intensity before the block

  // Step 0 continues the carry or starts the path.
  float c[VPL], o[VPL], prev[VPL];
  const int xp = p.x - dx;
  const bool from_carry = !carry.seed && path < W && xp >= 0 && xp < W;
  if (from_carry) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      prev[j] = d0 + j < D ? carry.in[static_cast<long>(xp) * D + d0 + j]
                           : inf_f();
    }
    last_int = carry.image[xp];
  }
  auto block_p2 = [&]() {
    float before = __shfl_up_sync(kFullMask, block_int, 1);
    if (lane == 0) before = last_int;
    const float p2s = p2_of(block_int, before, p1, p2, adaptive);
    last_int = __shfl_sync(kFullMask, block_int, 31);
    return p2s;
  };
  float p2s = block_p2();

  take(0, c, o);
  fetch();
  if (from_carry) {
    float L[VPL];
    advance<VPL>(L, c, prev, warp_min<VPL>(prev),
                 __shfl_sync(kFullMask, p2s, 0), lane, D, p1);
    store(first, first_pix, o, L, prev);
  } else {
    store(first, first_pix, o, c, prev);  // L = C
  }
  long at = first + step;
  long pix = first_pix + step_pix;
  for (int s = 1; s < p.len; ++s) {
    if ((s & 31) == 0) {
      block_int = next_int;
      next_int = intensities(s + 32);
      p2s = block_p2();
    }
    const float p2_adj = __shfl_sync(kFullMask, p2s, s & 31);
    take(s, c, o);
    fetch();
    float L[VPL];
    advance<VPL>(L, c, prev, warp_min<VPL>(prev), p2_adj, lane, D, p1);
    store(at, pix, o, L, prev);
    at += step;
    pix += step_pix;
  }

  // prev holds L at the path's last pixel.
  const int y_end = p.y + dy * (p.len - 1);
  if (carry.out != nullptr && y_end == (dy > 0 ? H - 1 : 0)) {
    const long x_end = p.x + dx * (p.len - 1);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (d0 + j < D) carry.out[x_end * D + d0 + j] = prev[j];
    }
  }
}

// The three kernels: one walk, one signature; the two whole-image kernels
// are launched with kNoCarry.  Separate names keep their launches apart in
// a profile.
#define STM_SGM_KERNEL(name)                                                \
  template <typename T, int VPL, bool VEC, bool ACC, bool FINAL>            \
  __global__ void name(const T* __restrict__ cost,                          \
                       const float* __restrict__ image,                     \
                       float* __restrict__ out,                             \
                       __nv_bfloat16* __restrict__ result, int H, int W,    \
                       int D, int dy, int dx, float p1, float p2,           \
                       int adaptive, Carry carry) {                         \
    extern __shared__ __align__(16) float ring[];                          \
    const int warp = threadIdx.x >> 5;                                      \
    const int path = blockIdx.x * kRingWarpsPerBlock + warp;                \
    if (path >= path_count(H, W, dy, dx)) return; /* whole warp leaves */  \
    ring_path<T, VPL, VEC, ACC, FINAL>(                                     \
        cost, image, out, result, H, W, D, dy, dx, p1, p2, adaptive != 0,   \
        path, carry, Fold{},                                                \
        reinterpret_cast<unsigned char*>(ring) +                            \
            warp * kRingBytes<T, VPL, VEC, ACC>);                           \
  }
STM_SGM_KERNEL(sgm_rows_kernel)        // dy = +-1, the whole image
STM_SGM_KERNEL(sgm_horizontal_kernel)  // dy = 0
STM_SGM_KERNEL(sgm_chunk_kernel)       // dy = +-1, a chunk of rows
#undef STM_SGM_KERNEL

// The side-by-side launch: traversal t of the first kSideBySide, with
// step (dy[t], dx[t]), writes its L into dst[t]; its blocks are
// [first[t], first[t + 1]).
struct Side {
  float* dst[kSideBySide];
  int dy[kSideBySide];
  int dx[kSideBySide];
  int first[kSideBySide + 1];
};

template <typename T, int VPL, bool VEC>
__global__ void sgm_side_by_side_kernel(const T* __restrict__ cost,
                                        const float* __restrict__ image,
                                        Side side, int H, int W, int D,
                                        float p1, float p2, int adaptive) {
  extern __shared__ __align__(16) float ring[];
  int t = 0;
#pragma unroll 1
  while (t + 1 < kSideBySide && static_cast<int>(blockIdx.x) >=
                                    side.first[t + 1]) {
    ++t;
  }
  const int dy = side.dy[t];
  const int dx = side.dx[t];
  const int warp = threadIdx.x >> 5;
  const int path = (static_cast<int>(blockIdx.x) - side.first[t]) *
                       kRingWarpsPerBlock + warp;
  if (path >= path_count(H, W, dy, dx)) return;  // whole warp leaves
  ring_path<T, VPL, VEC, false, false>(
      cost, image, side.dst[t], nullptr, H, W, D, dy, dx, p1, p2,
      adaptive != 0, path, Carry{nullptr, nullptr, nullptr, true}, Fold{},
      reinterpret_cast<unsigned char*>(ring) +
          warp * kRingBytes<T, VPL, VEC, false>);
}

// The folding launch: the last traversal, adding the kFolded partials and
// its L onto out (FINAL: into result, rounded to bf16).
template <typename T, int VPL, bool VEC, bool FINAL>
__global__ void sgm_fold_kernel(const T* __restrict__ cost,
                                const float* __restrict__ image,
                                float* __restrict__ out,
                                __nv_bfloat16* __restrict__ result, Fold fold,
                                int H, int W, int D, int dy, int dx, float p1,
                                float p2, int adaptive) {
  extern __shared__ __align__(16) float ring[];
  const int warp = threadIdx.x >> 5;
  const int path = blockIdx.x * kRingWarpsPerBlock + warp;
  if (path >= path_count(H, W, dy, dx)) return;  // whole warp leaves
  ring_path<T, VPL, VEC, true, FINAL, kFolded>(
      cost, image, out, result, H, W, D, dy, dx, p1, p2, adaptive != 0,
      path, Carry{nullptr, nullptr, nullptr, true}, fold,
      reinterpret_cast<unsigned char*>(ring) +
          warp * kRingBytes<T, VPL, VEC, true, kFolded>);
}

// The folding launch in its winner-takes-all form: the sums
// sgm_fold_kernel forms (bf16: rounded as its result holds them), each
// pixel's argmin stored into disparity [H, W] in place of its row; out is
// only read.
template <typename T, int VPL, bool VEC>
__global__ void sgm_fold_wta_kernel(const T* __restrict__ cost,
                                    const float* __restrict__ image,
                                    const float* __restrict__ out,
                                    int* __restrict__ disparity, Fold fold,
                                    int H, int W, int D, int dy, int dx,
                                    float p1, float p2, int adaptive) {
  extern __shared__ __align__(16) float ring[];
  const int warp = threadIdx.x >> 5;
  const int path = blockIdx.x * kRingWarpsPerBlock + warp;
  if (path >= path_count(H, W, dy, dx)) return;  // whole warp leaves
  ring_path<T, VPL, VEC, true, false, kFolded, true>(
      cost, image, const_cast<float*>(out), nullptr, H, W, D, dy, dx, p1, p2,
      adaptive != 0, path, Carry{nullptr, nullptr, nullptr, true}, fold,
      reinterpret_cast<unsigned char*>(ring) +
          warp * kRingBytes<T, VPL, VEC, true, kFolded>,
      disparity);
}

enum class Kind { kRows, kHorizontal, kChunk };

// One launch: the shape and penalties of the traversal, its carry, and
// (a bf16 volume's last traversal) the result it rounds into.
struct Launch {
  const void* cost;
  const float* image;
  float* out;
  __nv_bfloat16* result;
  int H, W, D, dy, dx;
  float p1, p2;
  int adaptive;
  Carry carry;
};

// Launches `kernel` over `blocks` blocks with `smem` bytes of dynamic
// shared memory, opting in past the default 48 KB.
template <typename Kernel, typename... Args>
int launch_blocks(Kernel kernel, size_t smem, int blocks, cudaStream_t stream,
                  Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, 32 * kRingWarpsPerBlock, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, VPL>{}) for the VPL that serves D.
template <typename F>
int by_vpl(int D, F&& f) {
  if (D <= 32) return f(std::integral_constant<int, 1>{});
  if (D <= 64) return f(std::integral_constant<int, 2>{});
  if (D <= 128) return f(std::integral_constant<int, 4>{});
  if (D <= 256) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, 16>{});
}

// go(std::true_type{}) where 16-byte pieces serve (VPL % 4 == 0 and
// `vec`), else go(std::false_type{}).
template <int VPL, typename F>
int by_vec(bool vec, F&& go) {
  if constexpr (VPL % 4 == 0) {
    if (vec) return go(std::true_type{});
  }
  return go(std::false_type{});
}

template <typename T, int VPL, bool VEC, bool ACC, bool FINAL>
int launch_kernel(Kind kind, const Launch& a, cudaStream_t stream) {
  using Kernel = decltype(&sgm_rows_kernel<T, VPL, VEC, ACC, FINAL>);
  Kernel kernel;
  if constexpr (FINAL) {  // a horizontal traversal is never the last
    kernel = kind == Kind::kRows ? &sgm_rows_kernel<T, VPL, VEC, ACC, FINAL>
                                 : &sgm_chunk_kernel<T, VPL, VEC, ACC, FINAL>;
  } else {
    kernel = kind == Kind::kRows
                 ? &sgm_rows_kernel<T, VPL, VEC, ACC, FINAL>
             : kind == Kind::kHorizontal
                 ? &sgm_horizontal_kernel<T, VPL, VEC, ACC, FINAL>
                 : &sgm_chunk_kernel<T, VPL, VEC, ACC, FINAL>;
  }
  const int paths = path_count(a.H, a.W, a.dy, a.dx);
  return launch_blocks(
      kernel,
      static_cast<size_t>(kRingWarpsPerBlock) * kRingBytes<T, VPL, VEC, ACC>,
      (paths + kRingWarpsPerBlock - 1) / kRingWarpsPerBlock, stream,
      static_cast<const T*>(a.cost), a.image, a.out, a.result, a.H, a.W, a.D,
      a.dy, a.dx, a.p1, a.p2, a.adaptive, a.carry);
}

bool aligned(const void* p, std::uintptr_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// 16-byte pieces where the shape and the pointers allow them.
template <typename T, int VPL, bool ACC, bool FINAL>
int launch_vec(Kind kind, const Launch& a, cudaStream_t stream) {
  if constexpr (VPL % 4 == 0) {
    if (a.D % (kIsF32<T> ? 4 : 8) == 0 && aligned(a.out, 16) &&
        aligned(a.cost, 16) && (!FINAL || aligned(a.result, 8))) {
      return launch_kernel<T, VPL, true, ACC, FINAL>(kind, a, stream);
    }
  }
  return launch_kernel<T, VPL, false, ACC, FINAL>(kind, a, stream);
}

template <typename T, int VPL>
int launch_ring(Kind kind, const Launch& a, bool accumulate,
                cudaStream_t stream) {
  if constexpr (!kIsF32<T>) {
    if (a.result != nullptr) {
      return launch_vec<T, VPL, true, true>(kind, a, stream);
    }
  }
  return accumulate ? launch_vec<T, VPL, true, false>(kind, a, stream)
                    : launch_vec<T, VPL, false, false>(kind, a, stream);
}

// Rows and chunks: dy = +-1, dx in {-1, 0, 1}; horizontal: dy == 0,
// |dx| == 1.  A result (bf16 volumes only) needs an accumulating rows or
// chunk launch.
template <typename T>
int dispatch(Kind kind, const void* cost, const void* image, void* out,
             void* result, int H, int W, int D, int dy, int dx, float p1,
             float p2, int adaptive, int accumulate, Carry carry,
             void* stream) {
  const bool ok = kind == Kind::kHorizontal
                      ? dy == 0 && (dx == 1 || dx == -1)
                      : (dy == 1 || dy == -1) && dx >= -1 && dx <= 1;
  const bool final_ok =
      result == nullptr ||
      (!kIsF32<T> && accumulate != 0 && kind != Kind::kHorizontal);
  if (!ok || !final_ok || D < 1 || D > 32 * 16 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch a{cost,
                 static_cast<const float*>(image),
                 static_cast<float*>(out),
                 static_cast<__nv_bfloat16*>(result),
                 H, W, D, dy, dx, p1, p2, adaptive, carry};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool acc = accumulate != 0;
  return by_vpl(D, [&](auto vpl) {
    return launch_ring<T, decltype(vpl)::value>(kind, a, acc, s);
  });
}

// One row traversal (dy = +-1) over a chunk of H rows with carry hand-off:
// carry [W, D] and carry_image [W] belong to the row before the chunk in
// scan order (ignored, and may be null, when seed is set); carry_out
// [W, D] receives the path costs of the chunk's last row in scan order.
template <typename T>
int dispatch_chunk(const void* cost, const void* image, const void* carry,
                   const void* carry_image, void* out, void* result,
                   void* carry_out, int H, int W, int D, int dy, int dx,
                   float p1, float p2, int adaptive, int seed, int accumulate,
                   void* stream) {
  // A chunk that does not seed needs the incoming carry.
  if (carry_out == nullptr ||
      (seed == 0 && (carry == nullptr || carry_image == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Carry hand_off{static_cast<const float*>(carry),
                       static_cast<const float*>(carry_image),
                       static_cast<float*>(carry_out), seed != 0};
  return dispatch<T>(Kind::kChunk, cost, image, out, result, H, W, D, dy, dx,
                     p1, p2, adaptive, accumulate, hand_off, stream);
}

// The side-by-side launch (the header of this file): the first
// kSideBySide traversals of TRAVERSALS at once, traversal t with step
// (steps[2t], steps[2t + 1]) (host ints, in TRAVERSALS order: the caller
// passes them, so the order lives in ops/aggregation.py alone), traversal
// 0 writing its L into out and traversal t > 0 into partial volume t - 1.
// 16-byte pieces where launch_vec would take them for every destination.
template <typename T>
int dispatch_side(const void* cost, const void* image, void* out,
                  void* partials, const int* steps, int H, int W, int D,
                  float p1, float p2, int adaptive, void* stream) {
  if (out == nullptr || partials == nullptr || steps == nullptr || D < 1 ||
      D > 32 * 16 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long plane = static_cast<long>(H) * W * D;
  Side side;
  side.first[0] = 0;
  for (int t = 0; t < kSideBySide; ++t) {
    const int dy = steps[2 * t];
    const int dx = steps[2 * t + 1];
    if (dy < -1 || dy > 1 || dx < -1 || dx > 1 || (dy == 0 && dx == 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    side.dst[t] = t == 0 ? static_cast<float*>(out)
                         : static_cast<float*>(partials) + (t - 1) * plane;
    side.dy[t] = dy;
    side.dx[t] = dx;
    const int paths = path_count(H, W, dy, dx);
    side.first[t + 1] = side.first[t] +
                        (paths + kRingWarpsPerBlock - 1) / kRingWarpsPerBlock;
  }
  const bool vec = D % (kIsF32<T> ? 4 : 8) == 0 && aligned(cost, 16) &&
                   aligned(out, 16) && aligned(partials, 16);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const T*>(cost);
  const auto* img = static_cast<const float*>(image);
  return by_vpl(D, [&](auto vpl) {
    constexpr int VPL = decltype(vpl)::value;
    return by_vec<VPL>(vec, [&](auto v) {
      constexpr bool VEC = decltype(v)::value;
      return launch_blocks(&sgm_side_by_side_kernel<T, VPL, VEC>,
                           static_cast<size_t>(kRingWarpsPerBlock) *
                               kRingBytes<T, VPL, VEC, false>,
                           side.first[kSideBySide], s, c, img, side, H, W, D,
                           p1, p2, adaptive);
    });
  });
}

// The folding launch: the row traversal (dy, dx) = the last of TRAVERSALS,
// adding the kFolded partial volumes and its L onto out, or (bf16, with a
// result) storing that sum rounded into result, or (with a disparity
// [H, W], then no result) storing each pixel's argmin of that sum there.
template <typename T>
int dispatch_fold(const void* cost, const void* image, void* out,
                  const void* partials, void* result, void* disparity,
                  int H, int W, int D, int dy, int dx, float p1, float p2,
                  int adaptive, void* stream) {
  const bool wta = disparity != nullptr;
  const bool final_ok =
      (kIsF32<T> || wta) ? result == nullptr : result != nullptr;
  if (!(dy == 1 || dy == -1) || dx < -1 || dx > 1 || !final_ok ||
      out == nullptr || partials == nullptr || D < 1 || D > 32 * 16 ||
      H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Fold fold{static_cast<const float*>(partials),
                  static_cast<long>(H) * W * D};
  const bool vec = D % (kIsF32<T> ? 4 : 8) == 0 && aligned(cost, 16) &&
                   aligned(out, 16) && aligned(partials, 16) &&
                   (kIsF32<T> || wta || aligned(result, 8));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const T*>(cost);
  const auto* img = static_cast<const float*>(image);
  auto* o = static_cast<float*>(out);
  auto* r = static_cast<__nv_bfloat16*>(result);
  auto* disp = static_cast<int*>(disparity);
  const int paths = path_count(H, W, dy, dx);
  const int blocks = (paths + kRingWarpsPerBlock - 1) / kRingWarpsPerBlock;
  return by_vpl(D, [&](auto vpl) {
    constexpr int VPL = decltype(vpl)::value;
    return by_vec<VPL>(vec, [&](auto v) {
      constexpr bool VEC = decltype(v)::value;
      const size_t smem = static_cast<size_t>(kRingWarpsPerBlock) *
                          kRingBytes<T, VPL, VEC, true, kFolded>;
      if (wta) {
        return launch_blocks(&sgm_fold_wta_kernel<T, VPL, VEC>, smem, blocks,
                             s, c, img, o, disp, fold, H, W, D, dy, dx, p1,
                             p2, adaptive);
      }
      return launch_blocks(&sgm_fold_kernel<T, VPL, VEC, !kIsF32<T>>, smem,
                           blocks, s, c, img, o, r, fold, H, W, D, dy, dx, p1,
                           p2, adaptive);
    });
  });
}

}  // namespace

// The entry points.  Every one takes, after p1 and p2, `adaptive`: 1 for
// the adaptive P2' = max(P1, P2 / |dI|), 0 for the constant max(P1, P2).

// The float32 entry points: cost, out and carries float32.

// One traversal of the vertical or a diagonal family (step dy = +-1).
extern "C" int stm_sgm_rows_f32(const void* cost, const void* image,
                                void* out, int H, int W, int D, int dy,
                                int dx, float p1, float p2, int adaptive,
                                int accumulate, void* stream) {
  return dispatch<float>(Kind::kRows, cost, image, out, nullptr, H, W, D, dy,
                         dx, p1, p2, adaptive, accumulate, kNoCarry, stream);
}

// One traversal of the horizontal family (step dy = 0, dx = +-1).
extern "C" int stm_sgm_horizontal_f32(const void* cost, const void* image,
                                      void* out, int H, int W, int D, int dy,
                                      int dx, float p1, float p2,
                                      int adaptive, int accumulate,
                                      void* stream) {
  return dispatch<float>(Kind::kHorizontal, cost, image, out, nullptr, H, W,
                         D, dy, dx, p1, p2, adaptive, accumulate, kNoCarry,
                         stream);
}

// One row traversal over a chunk of rows with carry hand-off
// (dispatch_chunk).
extern "C" int stm_sgm_chunk_f32(const void* cost, const void* image,
                                 const void* carry, const void* carry_image,
                                 void* out, void* carry_out, int H, int W,
                                 int D, int dy, int dx, float p1, float p2,
                                 int adaptive, int seed, int accumulate,
                                 void* stream) {
  return dispatch_chunk<float>(cost, image, carry, carry_image, out, nullptr,
                               carry_out, H, W, D, dy, dx, p1, p2, adaptive,
                               seed, accumulate, stream);
}

// The bf16-volume entry points: the cost volume bf16, out (the partial
// sum) and the carries float32.  A launch given a result (the last
// traversal) reads out, adds its path costs and stores the sums rounded to
// bf16 into result instead of out; it must accumulate, and a horizontal
// traversal takes none.  result may be null.
// One traversal of the vertical or a diagonal family (step dy = +-1).
extern "C" int stm_sgm_rows_bf16(const void* cost, const void* image,
                                 void* out, void* result, int H, int W,
                                 int D, int dy, int dx, float p1, float p2,
                                 int adaptive, int accumulate, void* stream) {
  return dispatch<__nv_bfloat16>(Kind::kRows, cost, image, out, result, H, W,
                                 D, dy, dx, p1, p2, adaptive, accumulate,
                                 kNoCarry, stream);
}

// One traversal of the horizontal family (step dy = 0, dx = +-1).
extern "C" int stm_sgm_horizontal_bf16(const void* cost, const void* image,
                                       void* out, int H, int W, int D,
                                       int dy, int dx, float p1, float p2,
                                       int adaptive, int accumulate,
                                       void* stream) {
  return dispatch<__nv_bfloat16>(Kind::kHorizontal, cost, image, out,
                                 nullptr, H, W, D, dy, dx, p1, p2, adaptive,
                                 accumulate, kNoCarry, stream);
}

// One row traversal over a chunk of rows with carry hand-off
// (dispatch_chunk); the carries stay float32.
extern "C" int stm_sgm_chunk_bf16(const void* cost, const void* image,
                                  const void* carry, const void* carry_image,
                                  void* out, void* result, void* carry_out,
                                  int H, int W, int D, int dy, int dx,
                                  float p1, float p2, int adaptive, int seed,
                                  int accumulate, void* stream) {
  return dispatch_chunk<__nv_bfloat16>(cost, image, carry, carry_image, out,
                                       result, carry_out, H, W, D, dy, dx,
                                       p1, p2, adaptive, seed, accumulate,
                                       stream);
}

// The side-by-side form of the whole aggregation, float32 and bf16 cost
// volumes: dispatch_side, then dispatch_fold on the same stream.  out and
// partials ([6, H, W, D]) are float32; steps holds the seven (dy, dx)
// pairs of the side-by-side launch, host ints.
extern "C" int stm_sgm_side_by_side_f32(const void* cost, const void* image,
                                        void* out, void* partials,
                                        const int* steps, int H, int W, int D,
                                        float p1, float p2, int adaptive,
                                        void* stream) {
  return dispatch_side<float>(cost, image, out, partials, steps, H, W, D, p1,
                              p2, adaptive, stream);
}

extern "C" int stm_sgm_side_by_side_bf16(const void* cost, const void* image,
                                         void* out, void* partials,
                                         const int* steps, int H, int W,
                                         int D, float p1, float p2,
                                         int adaptive, void* stream) {
  return dispatch_side<__nv_bfloat16>(cost, image, out, partials, steps, H,
                                      W, D, p1, p2, adaptive, stream);
}

// The last traversal (dy = +-1), folding the partials: out = ((out + P_1)
// + ... + P_6) + L.
extern "C" int stm_sgm_fold_f32(const void* cost, const void* image,
                                void* out, const void* partials, int H, int W,
                                int D, int dy, int dx, float p1, float p2,
                                int adaptive, void* stream) {
  return dispatch_fold<float>(cost, image, out, partials, nullptr, nullptr,
                              H, W, D, dy, dx, p1, p2, adaptive, stream);
}

// As stm_sgm_fold_f32, the sum stored rounded to bf16 into result (out is
// only read).
extern "C" int stm_sgm_fold_bf16(const void* cost, const void* image,
                                 void* out, const void* partials,
                                 void* result, int H, int W, int D, int dy,
                                 int dx, float p1, float p2, int adaptive,
                                 void* stream) {
  return dispatch_fold<__nv_bfloat16>(cost, image, out, partials, result,
                                      nullptr, H, W, D, dy, dx, p1, p2,
                                      adaptive, stream);
}

// The fold in its winner-takes-all form: the sum stm_sgm_fold_f32 forms,
// and in place of it each pixel's int32 argmin (torch.argmin's: the first
// NaN, else the first least value, -0.0 equal to +0.0) into disparity
// [H, W]; out is only read.
extern "C" int stm_sgm_fold_wta_f32(const void* cost, const void* image,
                                    void* out, const void* partials,
                                    void* disparity, int H, int W, int D,
                                    int dy, int dx, float p1, float p2,
                                    int adaptive, void* stream) {
  return dispatch_fold<float>(cost, image, out, partials, nullptr,
                              disparity, H, W, D, dy, dx, p1, p2, adaptive,
                              stream);
}

// As stm_sgm_fold_wta_f32, each sum rounded to bf16 first, as
// stm_sgm_fold_bf16's result holds it.
extern "C" int stm_sgm_fold_wta_bf16(const void* cost, const void* image,
                                     void* out, const void* partials,
                                     void* disparity, int H, int W, int D,
                                     int dy, int dx, float p1, float p2,
                                     int adaptive, void* stream) {
  return dispatch_fold<__nv_bfloat16>(cost, image, out, partials, nullptr,
                                      disparity, H, W, D, dy, dx, p1, p2,
                                      adaptive, stream);
}
