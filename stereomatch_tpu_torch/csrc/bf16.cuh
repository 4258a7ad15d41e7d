// bf16 <-> float32 for the kernels that store volumes as bf16.  Widening
// is exact: a bf16 value's 16 bits are a float32's high half (NaN payloads
// included, as __bfloat162float gives them).  Narrowing rounds to nearest
// even, as __float2bfloat16_rn and torch's .to(torch.bfloat16) do.  Also
// the staging of bf16 rows in a cp.async ring (copy_row_pieces).  Shared
// by sgm.cu, dp.cu and ssd.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace stm {

// The two bf16 values of a 32-bit word, widened (the lower address first).
__device__ __forceinline__ void widen_pair(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// N consecutive bf16 values (N = 1, 2, 4, 8 or 16) from an address
// aligned to min(2N, 16) bytes, in one load of up to 16 bytes at a time,
// widened.
template <int N>
__device__ __forceinline__ void widen_aligned(const __nv_bfloat16* src,
                                              float (&v)[N]) {
  static_assert(N == 1 || N == 2 || N == 4 || N == 8 || N == 16,
                "N is a power of two up to 16");
  if constexpr (N == 1) {
    v[0] = __bfloat162float(src[0]);
  } else if constexpr (N == 2) {
    widen_pair(*reinterpret_cast<const unsigned*>(src), v);
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    widen_pair(x.x, v);
    widen_pair(x.y, v + 2);
  } else {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(src)[i];
      widen_pair(x.x, v + 8 * i);
      widen_pair(x.y, v + 8 * i + 2);
      widen_pair(x.z, v + 8 * i + 4);
      widen_pair(x.w, v + 8 * i + 6);
    }
  }
}

// Four floats rounded to nearest even into four bf16 values in address
// order: one 8-byte store.
__device__ __forceinline__ uint2 narrow4(float a, float b, float c,
                                         float d) {
  auto bits = [](float x) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
  };
  return make_uint2(bits(a) | (bits(b) << 16), bits(c) | (bits(d) << 16));
}

// A row of D bf16 values in a cp.async ring (the SGM walk's cost rows,
// the DP forward pass's columns).  A row may start at any 2-byte boundary
// (odd D, a view at an odd element offset), and cp.async copies no fewer
// than 4 bytes, so a slot takes the aligned 16-byte pieces that hold the
// row, and the row is read at its offset into the first piece
// (row_lead).  Each piece holds a byte of the row, so it lies in the
// volume's pages.

// Bytes of a slot for rows of up to N values: the row's own bytes where
// every row starts a 16-byte piece (ALIGNED), else one piece more.
template <int N, bool ALIGNED>
constexpr int kRowSlotBytes = 2 * N + (ALIGNED ? 0 : 16);

// Byte offset of a row into its first 16-byte piece.
__device__ __forceinline__ int row_lead(const __nv_bfloat16* row) {
  return static_cast<int>(reinterpret_cast<std::uintptr_t>(row) & 15);
}

// The warp copies the pieces that hold the D values at `row` into `slot`
// (SLOT bytes), lane `lane` every 32nd piece; a piece is issued only
// where `live` holds and it holds a byte of the row.  The row's values
// then start at slot + row_lead(row).
template <int SLOT>
__device__ __forceinline__ void copy_row_pieces(unsigned char* slot,
                                                const __nv_bfloat16* row,
                                                int D, bool live, int lane) {
  constexpr int kPieces = SLOT / 16;
  const unsigned char* const base = reinterpret_cast<const unsigned char*>(
      reinterpret_cast<std::uintptr_t>(row) & ~std::uintptr_t(15));
  const int bytes = row_lead(row) + 2 * D;
#pragma unroll
  for (int i = 0; i < (kPieces + 31) / 32; ++i) {
    const int q = i * 32 + lane;
    copy16(slot + 16 * q, base + 16 * q,
           live && q < kPieces && 16 * q < bytes);
  }
}

}  // namespace stm
