// Scanline dynamic-programming disparity reducer for Hopper (sm_90a).
//
// Replaces: stereomatch_tpu/ops/dp_pallas.py, _forward_kernel
// (dp_forward_kernel) and _backward_kernel (dp_backward_kernel), entered
// through dynamic_programming_pallas.  The TPU kernels swept W on a
// sequential grid with an [H, D] accumulator in VMEM and carried the
// backward walk's current disparity as a one-hot [H, D] mask, because a
// TPU has no per-row gather.  Here an index does: the walk reads its
// pointer directly.
//
// Semantics (plain version: stereomatch_tpu_torch/ops/disparity.py):
//   acc[0, d] = C[0, d]; ptr[0, d] = 0
//   acc[w, d] = C[w, d] + min3, with c1 = acc[w-1, d-1], c2 = acc[w-1, d],
//     c3 = acc[w-1, d+1] (+inf beyond the band) and the reference's chain
//     ptr = -1 if c1 < c2 && c1 < c3, else 0 if c2 < c3, else +1
//   d[W-1] = argmin_d acc[W-1, d] (torch.argmin: the first NaN, else the
//     first minimum; -0 and +0 are equal)
//   d[w]   = clip(d[w+1] + ptr[w, d[w+1]], 0, D-1)
// One __fadd_rn per step after exact comparisons, and integer arithmetic
// in the walk: equal to the plain version bit for bit, whatever the lane
// mapping, staging or walk order.
//
// Layout: the cost volume [H, W, D] as it comes, pointers int8 [H, W, D]
// (no transpose), final costs [H, D], disparities int32 [H, W].
//
// What bounds it on an H100: by bytes, the forward pass reads the float32
// volume once and writes the int8 pointers once (0.032 ms at teddy
// 375x450 D=128, 0.50 ms at HD 1024x1280 D=256, at 3.35 TB/s); the walk
// needs one pointer a pixel.  In fact both are W-long dependency chains,
// one a row, with only H rows (375-1024 warps) to hide a step's latency.
// Measured (PERF.md §6): the forward pass runs at 79% of its bytes at
// HD and is held by its step chain and pointer stores at teddy; the walk
// is held by its step chain at teddy and by the round trips of its window
// copies at HD.
//
// Forward (dp_forward_kernel): one warp a row.  Lane l holds the J
// consecutive disparities d = J*l + j, so a step's d +- 1 neighbours are
// in the lane's own registers except at its two ends: two shuffles a
// step.  The step's J pointers are contiguous bytes, one J-byte store a
// lane.  The costs come through a ring of kFwdStages = 16 columns in shared
// memory that cp.async fills that many columns ahead of the step (the
// scheme of sgm.cu's ring_path), so the loads of the next columns are in
// flight behind the chain.
//
// Backward (dp_backward_kernel): one warp a row.  The argmin is a warp
// reduction over (value, index).  The walk goes in batches of kBatch = 32
// steps.  A pointer is -1, 0 or +1, so from the disparity at a batch's
// start its 32 steps stay within 32 of it, and that start lies within 32
// of the previous batch's start: a window of +-kReach = 64 disparities
// around the previous batch's start holds every pointer a batch reads.
// Lane i copies the window of the batch's column i into shared memory by
// cp.async (9 pieces of 16 bytes), one batch ahead of the walk, and all
// lanes then walk the same 32 steps from broadcast shared-memory reads;
// lane i keeps step i's disparity, and the batch leaves as one coalesced
// store.  HD takes 40 memory round trips a row, overlapped with the walk,
// instead of 1279 dependent loads.  A step reads its window unchecked (a
// shared load, an add and the clip), and notes beside the chain whether
// its disparity lay outside the window; if one did (possible only for
// pointers outside {-1, 0, +1}, which dp_backward_cuda accepts as the
// plain version does), the warp walks the batch again from its start with
// every pointer read from device memory.
//
// bfloat16 storage (stm_dp_forward_bf16): the forward pass reads a bf16
// cost volume and widens each value as a lane takes it from the ring (the
// plain version and XLA widen the volume to float32 first, ops/disparity.py
// :157); the accumulator, the final costs and the pointers are unchanged,
// and the walk does not read costs.  A bf16 column may start at any 2-byte
// boundary and cp.async copies no fewer than 4 bytes, so the warp copies
// the aligned 16-byte pieces that hold the column and reads it at its
// offset into the first piece (bf16.cuh's copy_row_pieces).  The
// function's bytes fall from 5 to 3 a cell: 0.30 ms at HD.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "bf16.cuh"
#include "cp_async.cuh"

namespace {

using stm::commit_copies;
using stm::copy16;
using stm::copy4;
using stm::wait_copies;

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// ---------------------------------------------------------------- forward

// The ring's depth in columns, the step loop's unroll and the warps of a
// block, from the ablations in PERF.md §6: 16 columns keep 15 in
// flight, 8 KB a warp at teddy and 16 KB at HD (32 gained nothing at
// teddy, 8 lost at both); unrolled by 4 the step runs faster at J = 8
// (HD) and slower at J = 4 (teddy); one-warp blocks spread the rows over
// all SMs.
constexpr int kFwdStages = 16;
template <int J>
constexpr int kFwdUnroll = J <= 4 ? 1 : 4;
constexpr int kFwdWarpsPerBlock = 1;

// Bytes of a column's ring slot: float32, the 32 * J costs as the lanes
// read them; bf16, the 16-byte pieces that hold 32 * J values (bf16.cuh;
// with VEC every column starts a piece).
template <typename T, int J, bool VEC>
constexpr int kFwdSlotBytes = std::is_same<T, float>::value
                                  ? 4 * 32 * J
                                  : stm::kRowSlotBytes<32 * J, VEC>;

// A lane's J pointers as little-endian bytes of 32-bit words, packed
// outside the store's predicate so that the store is one instruction.
template <int J>
struct Packed {
  uint32_t word[(J + 3) / 4];
};

template <int J>
__device__ __forceinline__ Packed<J> pack(const int8_t (&p)[J]) {
  Packed<J> v;
#pragma unroll
  for (int k = 0; k < (J + 3) / 4; ++k) {
    v.word[k] = 0;
#pragma unroll
    for (int i = 0; i < 4 && 4 * k + i < J; ++i) {
      v.word[k] |= static_cast<uint32_t>(static_cast<uint8_t>(p[4 * k + i]))
                   << (8 * i);
    }
  }
  return v;
}

// One aligned J-byte store.
template <int J>
__device__ __forceinline__ void write(int8_t* dst, const Packed<J>& v) {
  if constexpr (J == 1) {
    *dst = static_cast<int8_t>(v.word[0]);
  } else if constexpr (J == 2) {
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(v.word[0]);
  } else if constexpr (J == 4) {
    *reinterpret_cast<uint32_t*>(dst) = v.word[0];
  } else if constexpr (J == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(v.word[0], v.word[1]);
  } else {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(v.word[0], v.word[1], v.word[2], v.word[3]);
  }
}

// VEC: D % 16 == 0 and 16-byte-aligned pointers and cost, so a lane's J
// disparities lie wholly inside D or wholly past it, its J pointers are
// one aligned J-byte store, (J % 4 == 0) float32 costs come in 16-byte
// pieces and every bf16 column starts a 16-byte piece, its J values one
// load a lane; otherwise byte stores, 4-byte pieces of float32 and bf16
// columns read at their offset into the aligned pieces that hold them.
template <typename T, int J, bool VEC>
__global__ void dp_forward_kernel(const T* __restrict__ cost,
                                  int8_t* __restrict__ ptr,
                                  float* __restrict__ final_costs, int H,
                                  int W, int D) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int S = kFwdStages;
  static_assert(S >= 4 && (S & (S - 1)) == 0, "S is a power of two >= 4");
  constexpr int kRow = 32 * J;                      // floats a stage
  constexpr int kPiece = VEC && J % 4 == 0 ? 4 : 1;  // floats a copy
  constexpr int kPieces = J / kPiece;               // copies a lane
  constexpr int kSlot = kFwdSlotBytes<T, J, VEC>;
  extern __shared__ __align__(16) float fwd_ring[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kFwdWarpsPerBlock + warp;
  if (h >= H) return;  // the whole warp leaves
  unsigned char* const ring_bytes =
      reinterpret_cast<unsigned char*>(fwd_ring) + warp * S * kSlot;
  float* const ring = reinterpret_cast<float*>(ring_bytes);
  const size_t row = static_cast<size_t>(h) * W * D;
  const int d0 = J * lane;
  const float inf = pos_inf();
  // live[j]: d0 + j < D (with VEC one test a lane).
  bool live[J];
#pragma unroll
  for (int j = 0; j < J; ++j) live[j] = VEC ? d0 < D : d0 + j < D;

  // Piece i of a column starts at float e[i]; in[i]: it lies inside D.
  int e[kPieces];
  bool in[kPieces];
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    e[i] = i * 32 * kPiece + kPiece * lane;
    in[i] = e[i] < D;
  }
  // Columns 0, 1, ... in turn into their stages; one commit group each,
  // so at column w exactly S - 1 + w groups are committed, and waiting
  // until at most S - 2 are pending means column w's group has landed.
  // The copies of column w + S - 1, issued at column w after its wait, go
  // to the stage of column w - 1, which every lane finished reading
  // before the __syncwarp of column w.
  int fetched = 0;
  const T* ahead = cost + row;  // column `fetched`
  auto fetch = [&]() {
    const bool go = fetched < W;
    if constexpr (kF32) {
      float* const dst = ring + (fetched & (S - 1)) * kRow;
#pragma unroll
      for (int i = 0; i < kPieces; ++i) {
        if constexpr (kPiece == 4) {
          copy16(dst + e[i], ahead + e[i], go && in[i]);
        } else {
          copy4(dst + e[i], ahead + e[i], go && in[i]);
        }
      }
    } else {
      stm::copy_row_pieces<kSlot>(ring_bytes + (fetched & (S - 1)) * kSlot,
                                  ahead, D, go, lane);
    }
    commit_copies();
    ++fetched;
    ahead += D;
  };
  // Column w's costs from its stage (entries past D are never used).
  auto take = [&](int w, float (&c)[J]) {
    wait_copies<S - 2>();
    __syncwarp();
    if constexpr (kF32) {
      const float* const src = ring + (w & (S - 1)) * kRow + d0;
#pragma unroll
      for (int j = 0; j < J; ++j) c[j] = src[j];
    } else if constexpr (VEC) {
      stm::widen_aligned<J>(reinterpret_cast<const __nv_bfloat16*>(
                                ring_bytes + (w & (S - 1)) * kSlot) + d0,
                            c);
    } else {
      const int lead =
          stm::row_lead(cost + row + static_cast<size_t>(w) * D);
      const __nv_bfloat16* const src =
          reinterpret_cast<const __nv_bfloat16*>(
              ring_bytes + (w & (S - 1)) * kSlot + lead) + d0;
#pragma unroll
      for (int j = 0; j < J; ++j) c[j] = __bfloat162float(src[j]);
    }
  };
  int8_t* at = ptr + row + d0;  // this lane's pointers of the next column
  auto store = [&](const int8_t (&p)[J]) {
    if constexpr (VEC) {
      const Packed<J> v = pack<J>(p);
      if (live[0]) write<J>(at, v);
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (live[j]) at[j] = p[j];
      }
    }
    at += D;
  };

#pragma unroll 1
  for (int t = 0; t < S - 1; ++t) fetch();

  float acc[J];
  int8_t p[J];
  take(0, acc);
  fetch();
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (!live[j]) acc[j] = inf;  // padding: +inf above D - 1
    p[j] = 0;
  }
  store(p);

  auto step = [&](int w) {
    float cur[J];
    take(w, cur);
    fetch();
    // acc[d0 - 1] and acc[d0 + J]: the neighbouring lanes' end registers.
    float up = __shfl_up_sync(kFull, acc[J - 1], 1);
    float dn = __shfl_down_sync(kFull, acc[0], 1);
    if (lane == 0) up = inf;
    if (lane == 31) dn = inf;
    float out[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float c1 = j > 0 ? acc[j - 1] : up;
      const float c2 = acc[j];
      const float c3 = j + 1 < J ? acc[j + 1] : dn;
      const bool take1 = c1 < c2 && c1 < c3;
      const bool take2 = c2 < c3;
      const float m = take1 ? c1 : (take2 ? c2 : c3);
      out[j] = live[j] ? __fadd_rn(cur[j], m) : inf;
      p[j] = take1 ? int8_t(-1) : (take2 ? int8_t(0) : int8_t(1));
    }
    store(p);
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = out[j];
  };
  if constexpr (kFwdUnroll<J> == 4) {
#pragma unroll 4
    for (int w = 1; w < W; ++w) step(w);
  } else {
    static_assert(kFwdUnroll<J> == 1, "an unroll of 1 or 4");
#pragma unroll 1
    for (int w = 1; w < W; ++w) step(w);
  }

#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (live[j]) final_costs[static_cast<size_t>(h) * D + d0 + j] = acc[j];
  }
}

// --------------------------------------------------------------- backward

constexpr int kBatch = 32;          // steps a batch, one a lane
constexpr int kReach = 2 * kBatch;  // a window's half-width
// 16-byte pieces that cover 2 * kReach + 1 bytes from any alignment.
constexpr int kWindowPieces = (2 * kReach + 1 + 15 + 15) / 16;
constexpr int kSlot = 16 * kWindowPieces;  // bytes of one column's window
constexpr int kBuffer = kBatch * kSlot;    // a batch's windows
// Bytes of shared memory before and after a warp's two buffers: a step
// reads byte d - lo + (0..15) of its slot unchecked, which for any
// d, lo < D <= kMaxDisparity lies at most 511 bytes before its buffer or
// 383 past it.
constexpr int kMaxDisparity = 512;
constexpr int kGuard = 512;
static_assert(kGuard >= kMaxDisparity - 1 &&
                  kGuard >= (kBatch - 1) * kSlot + kMaxDisparity + 15 - kBuffer,
              "the guard bands hold every unchecked read");
constexpr int kBackWarpBytes = kGuard + 2 * kBuffer + kGuard;
constexpr int kBackWarpsPerBlock = 1;
static_assert(kBatch == 32, "a batch has one step a lane");
static_assert(kWindowPieces == 9, "129 bytes from any alignment: 9 pieces");

// torch.argmin's order over (value, index): a NaN before any number (the
// first NaN), else the smaller value, else (equal values, -0 == +0) the
// lower index.  A total order, so every lane of a butterfly agrees.
__device__ __forceinline__ bool argmin_before(float v, int i, float u,
                                              int k) {
  const bool v_nan = v != v;
  const bool u_nan = u != u;
  if (v_nan || u_nan) return v_nan && (!u_nan || i < k);
  return v < u || (v == u && i < k);
}

__global__ void dp_backward_kernel(const int8_t* __restrict__ ptr,
                                   const float* __restrict__ final_costs,
                                   int* __restrict__ disp, int H, int W,
                                   int D) {
  __shared__ __align__(16) int8_t windows[kBackWarpsPerBlock][kBackWarpBytes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kBackWarpsPerBlock + warp;
  if (h >= H) return;  // the whole warp leaves

  // The final column's argmin: each lane over d = lane + 32 i in order,
  // then a butterfly.  A lane past D holds (+inf, D), after every d.
  const float* const f = final_costs + static_cast<size_t>(h) * D;
  float best_v = pos_inf();
  int best = D;
  for (int d = lane; d < D; d += 32) {
    const float v = f[d];
    if (argmin_before(v, d, best_v, best)) {
      best_v = v;
      best = d;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(kFull, best_v, off);
    const int i = __shfl_xor_sync(kFull, best, off);
    if (argmin_before(v, i, best_v, best)) {
      best_v = v;
      best = i;
    }
  }

  const int8_t* const row = ptr + static_cast<size_t>(h) * W * D;
  const uintptr_t row_addr = reinterpret_cast<uintptr_t>(row);
  int* const out = disp + static_cast<size_t>(h) * W;
  int cur = best;
  if (lane == 0) out[W - 1] = cur;

  // Batch b walks columns top(b) - 1 down to top(b) - kBatch (those >= 0),
  // top(b) = W - 1 - kBatch * b; its window is [lo, hi] around `center`,
  // the disparity at the previous batch's start.  Lane i copies the
  // window of column top(b) - 1 - i: the 16-byte-aligned pieces that hold
  // a byte of it, so every piece lies inside the volume's pages.  One
  // commit group a batch.
  auto buffer = [&](int b) {
    return windows[warp] + kGuard + (b & 1) * kBuffer;
  };
  auto fetch = [&](int b, int center) {
    const int col = W - 2 - kBatch * b - lane;
    const int lo = max(center - kReach, 0);
    const int hi = min(center + kReach, D - 1);
    const uintptr_t at = row_addr + static_cast<size_t>(max(col, 0)) * D;
    const uintptr_t first = (at + lo) & ~uintptr_t(15);
    int8_t* const slot = buffer(b) + lane * kSlot;
#pragma unroll
    for (int i = 0; i < kWindowPieces; ++i) {
      const uintptr_t src = first + 16 * i;
      copy16(slot + 16 * i, reinterpret_cast<const void*>(src),
             col >= 0 && src <= at + hi);
    }
    commit_copies();
  };

  fetch(0, cur);
  fetch(1, cur);
  int center = cur;  // batch b's window centre
  for (int b = 0; W - 1 - kBatch * b > 0; ++b) {
    const int top = W - 1 - kBatch * b;
    const int n = min(kBatch, top);
    const int lo = max(center - kReach, 0);
    const int hi = min(center + kReach, D - 1);
    wait_copies<1>();
    __syncwarp();
    const int8_t* const slots = buffer(b);
    const int start = cur;
    int mine = 0;
    // The steps read their windows unchecked, so that a step is one
    // shared load, an add and the clip; whether a step's disparity lay
    // outside [lo, hi] is noted beside the chain.
    bool left = false;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k < n) {
        const uintptr_t at = row_addr + static_cast<size_t>(top - 1 - k) * D;
        // Byte d of the column sits at slot byte d - lo + (at + lo) % 16.
        const int base = k * kSlot + static_cast<int>((at + lo) & 15) - lo;
        left |= static_cast<unsigned>(cur - lo) > static_cast<unsigned>(hi - lo);
        cur = min(max(cur + slots[base + cur], 0), D - 1);
        if (lane == k) mine = cur;
      }
    }
    if (left) {
      // A pointer outside {-1, 0, +1} took the walk off its window (the
      // same chain in every lane, so the whole warp): the batch again from
      // its start, every pointer from device memory.
      cur = start;
      for (int k = 0; k < n; ++k) {
        cur += row[static_cast<size_t>(top - 1 - k) * D + cur];
        cur = min(max(cur, 0), D - 1);
        if (lane == k) mine = cur;
      }
    }
    if (lane < n) out[top - 1 - lane] = mine;
    __syncwarp();  // every lane is done with this batch's windows
    fetch(b + 2, cur);
    center = start;
  }
}

template <typename T, int J, bool VEC>
int launch_forward(const void* cost, void* ptr, void* final_costs, int H,
                   int W, int D, cudaStream_t stream) {
  constexpr size_t kSmem =
      static_cast<size_t>(kFwdWarpsPerBlock) * kFwdStages *
      kFwdSlotBytes<T, J, VEC>;
  static_assert(kSmem <= 48 * 1024, "the ring fits static-size limits");
  const int blocks = (H + kFwdWarpsPerBlock - 1) / kFwdWarpsPerBlock;
  dp_forward_kernel<T, J, VEC><<<blocks, 32 * kFwdWarpsPerBlock, kSmem,
                                 stream>>>(
      static_cast<const T*>(cost), static_cast<int8_t*>(ptr),
      static_cast<float*>(final_costs), H, W, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int J>
int launch_forward_vec(const void* cost, void* ptr, void* final_costs, int H,
                       int W, int D, cudaStream_t stream) {
  if (D % 16 == 0 && reinterpret_cast<std::uintptr_t>(cost) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0) {
    return launch_forward<T, J, true>(cost, ptr, final_costs, H, W, D,
                                      stream);
  }
  return launch_forward<T, J, false>(cost, ptr, final_costs, H, W, D,
                                     stream);
}

// D <= kMaxDisparity (16 registers a lane); the wrapper checks too.
template <typename T>
int forward(const void* cost, void* ptr, void* final_costs, int H, int W,
            int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 1 || W < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) {
    return launch_forward_vec<T, 1>(cost, ptr, final_costs, H, W, D, s);
  }
  if (D <= 64) {
    return launch_forward_vec<T, 2>(cost, ptr, final_costs, H, W, D, s);
  }
  if (D <= 128) {
    return launch_forward_vec<T, 4>(cost, ptr, final_costs, H, W, D, s);
  }
  if (D <= 256) {
    return launch_forward_vec<T, 8>(cost, ptr, final_costs, H, W, D, s);
  }
  if (D <= kMaxDisparity) {
    return launch_forward_vec<T, 16>(cost, ptr, final_costs, H, W, D, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int stm_dp_forward_f32(const void* cost, void* ptr,
                                  void* final_costs, int H, int W, int D,
                                  void* stream) {
  return forward<float>(cost, ptr, final_costs, H, W, D, stream);
}

// A bf16 cost volume; pointers and final costs as stm_dp_forward_f32's.
extern "C" int stm_dp_forward_bf16(const void* cost, void* ptr,
                                   void* final_costs, int H, int W, int D,
                                   void* stream) {
  return forward<__nv_bfloat16>(cost, ptr, final_costs, H, W, D, stream);
}

extern "C" int stm_dp_backward(const void* ptr, const void* final_costs,
                               void* disp, int H, int W, int D,
                               void* stream) {
  if (H < 1 || W < 1 || D < 1 || D > kMaxDisparity) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (H + kBackWarpsPerBlock - 1) / kBackWarpsPerBlock;
  dp_backward_kernel<<<blocks, 32 * kBackWarpsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ptr), static_cast<const float*>(final_costs),
      static_cast<int*>(disp), H, W, D);
  return static_cast<int>(cudaGetLastError());
}
