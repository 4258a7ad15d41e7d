// Census codes and their Hamming cost volume [H, W, D] for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the census in XLA and
// has no Pallas kernel for it.  The port's plain version
// (stereomatch_tpu_torch/ops/cost.py: census_transform, then
// census_hamming_from_codes) stacks the window's shifted neighbour planes
// into [H, W, n_bits], packs them into int32 words, and for each word
// gathers the right codes over D, XORs and counts bits in a dozen
// elementwise passes over [H, W, D] int32 volumes: about 85 operations
// and 120 bytes of device traffic for each 4-byte cost at KITTI's 9x7
// window.  These two kernels stay the plain version's two halves, so that
// a stamp can sit between them (utils/profiling.py, "census_codes").
//
// Semantics:
//   code[y, x] bit k = neighbour k < centre, neighbours in row-major
//                      window order with the centre skipped, bit k in
//                      word k / 32; out-of-image neighbours read 0
//                      (the plain version's F.pad);
//   cost[y, x, d]    = sum over words of popcount(codeL[y, x] ^
//                      codeR[y, x - d - o]), o = disparity_offset;
//                      +inf (INT_MAX for int32) where x < d + o.
// The comparisons are of the same float32 values, __popc counts the sign
// bit as popcount32 does, and a sum is an integer of at most 128, exact in
// float32, bf16 and int32: both kernels equal the plain version bit for
// bit in every dtype.
//
// What bounds it on an H100: the volume's store, H*W*D*4 bytes (238.5 MB
// at KITTI 375x1242 D=128, 71 us at 3.35 TB/s); the codes are 7.45 MB
// and the images 3.7 MB.  The design writes every cell once and keeps the
// codes' reuse in shared memory:
//
// * census_codes_kernel<Words>: one launch for both images (blockIdx.z).
//   A block stages an 8 x 32 pixel tile of its image with the window's
//   halo in shared memory (zero outside the image); each thread builds
//   its pixel's Words int32 words in registers and stores them in the
//   plain layout, [H, W, Words] ([H, W] for one word).  It walks the
//   window backwards and shifts each bit in at bit 0 of the Words-word
//   register (a funnel shift a word), so the first neighbour ends at bit
//   0 with no bit index kept: about eight instructions a neighbour, where
//   a counted bit index with its wrap and centre tests took twice that.
// * census_hamming_kernel<Words, O>: a block owns one row, kTX output
//   columns and up to kDC disparities.  It stages the left codes of its
//   columns and the right codes of columns [x0 - o - d_last, x0 + kTX -
//   o) in shared memory; each thread takes one column and four
//   consecutive disparities, so that a warp writes one pixel's 128
//   disparities (512 contiguous bytes of float32) with 16-byte stores.
//   The four disparities read four consecutive right codes, which lie at
//   any 4-byte offset; the right codes are staged four times, each copy
//   shifted by one more int, so that every thread reads its four from one
//   16-byte-aligned copy in one conflict-free load.  Where D % 4 != 0 or
//   the output is misaligned, the four cells are stored one by one.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

constexpr int kMaxWords = 4;        // windows of up to 128 neighbours

// census_codes_kernel: a block's tile of pixels.
constexpr int kCodeTX = 32;
constexpr int kCodeTY = 8;

// census_hamming_kernel: a block's output columns and disparities.
constexpr int kTX = 32;
constexpr int kDC = 128;
constexpr int kThreads = 256;
// Staged right codes of a copy: kTX + kDC - 1 columns, 3 in front (the
// last group of four may reach 3 below the staged range when D % 4 != 0)
// and 3 of shift, rounded up to 16 bytes.
constexpr int kSpan = (kTX + kDC - 1 + 6 + 3) / 4 * 4;

template <int Words>
__global__ void __launch_bounds__(kCodeTX* kCodeTY)
    census_codes_kernel(const float* __restrict__ left,
                        const float* __restrict__ right,
                        int* __restrict__ codes_left,
                        int* __restrict__ codes_right, int H, int W,
                        int win_w, int win_h, int strips) {
  extern __shared__ float tile[];
  const int half_w = win_w / 2, half_h = win_h / 2;
  const int span_w = kCodeTX + win_w - 1;
  const int span_h = kCodeTY + win_h - 1;
  const float* const img = blockIdx.z ? right : left;
  int* const codes = blockIdx.z ? codes_right : codes_left;
  const int x0 = static_cast<int>(blockIdx.x % strips) * kCodeTX;
  const int y0 = static_cast<int>(blockIdx.x / strips) * kCodeTY;
  for (int i = threadIdx.y * kCodeTX + threadIdx.x; i < span_w * span_h;
       i += kCodeTX * kCodeTY) {
    const int r = i / span_w, c = i - r * span_w;
    const int y = y0 - half_h + r, x = x0 - half_w + c;
    tile[i] = (y >= 0 && y < H && x >= 0 && x < W)
                  ? img[static_cast<size_t>(y) * W + x]
                  : 0.0f;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float* const at = tile + threadIdx.y * span_w + threadIdx.x;
  const float centre = at[half_h * span_w + half_w];
  unsigned words[Words] = {};
  // Neighbour k of the row-major order (centre skipped) ends at bit k:
  // the window is walked from its last neighbour to its first, each bit
  // shifted in at the bottom.
  auto take = [&](float v) {
#pragma unroll
    for (int w = Words - 1; w > 0; --w) {
      words[w] = __funnelshift_l(words[w - 1], words[w], 1);
    }
    words[0] = (words[0] << 1) | static_cast<unsigned>(v < centre);
  };
  for (int dy = win_h - 1; dy > half_h; --dy) {
    for (int dx = win_w - 1; dx >= 0; --dx) take(at[dy * span_w + dx]);
  }
  const float* const mid = at + half_h * span_w;
  for (int dx = win_w - 1; dx > half_w; --dx) take(mid[dx]);
  for (int dx = half_w - 1; dx >= 0; --dx) take(mid[dx]);
  for (int dy = half_h - 1; dy >= 0; --dy) {
    for (int dx = win_w - 1; dx >= 0; --dx) take(at[dy * span_w + dx]);
  }
  int* const dst = codes + (static_cast<size_t>(y) * W + x) * Words;
#pragma unroll
  for (int w = 0; w < Words; ++w) dst[w] = static_cast<int>(words[w]);
}

// A cost cell of each output type: the Hamming sum where the cell is
// valid, else +inf (INT_MAX for int32); four cells in one store.
template <typename O>
struct Cells;

template <>
struct Cells<float> {
  static __device__ __forceinline__ float of(int h, bool ok) {
    return ok ? static_cast<float>(h) : __int_as_float(0x7f800000);
  }
  static __device__ __forceinline__ void four(float* p, const int (&h)[4],
                                              const bool (&ok)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(
        of(h[0], ok[0]), of(h[1], ok[1]), of(h[2], ok[2]), of(h[3], ok[3]));
  }
};

template <>
struct Cells<int> {
  static __device__ __forceinline__ int of(int h, bool ok) {
    return ok ? h : INT_MAX;
  }
  static __device__ __forceinline__ void four(int* p, const int (&h)[4],
                                              const bool (&ok)[4]) {
    *reinterpret_cast<int4*>(p) = make_int4(
        of(h[0], ok[0]), of(h[1], ok[1]), of(h[2], ok[2]), of(h[3], ok[3]));
  }
};

template <>
struct Cells<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 of(int h, bool ok) {
    return __float2bfloat16_rn(Cells<float>::of(h, ok));
  }
  static __device__ __forceinline__ void four(__nv_bfloat16* p,
                                              const int (&h)[4],
                                              const bool (&ok)[4]) {
    *reinterpret_cast<uint2*>(p) = stm::narrow4(
        Cells<float>::of(h[0], ok[0]), Cells<float>::of(h[1], ok[1]),
        Cells<float>::of(h[2], ok[2]), Cells<float>::of(h[3], ok[3]));
  }
};

template <int Words, typename O>
__global__ void __launch_bounds__(kThreads)
    census_hamming_kernel(const int* __restrict__ codes_left,
                          const int* __restrict__ codes_right,
                          O* __restrict__ out, int H, int W, int D,
                          int offset, int strips, bool vec) {
  __shared__ unsigned left_codes[Words][kTX];
  // Element j of the staged right codes lies at [s][w][j + 3 + s].
  __shared__ __align__(16) unsigned right_codes[4][Words][kSpan];
  const int x0 = static_cast<int>(blockIdx.x % strips) * kTX;
  const int y = static_cast<int>(blockIdx.x / strips);
  const int d0 = blockIdx.y * kDC;
  const int dn = min(kDC, D - d0);  // the block's disparities
  const int span = kTX + dn - 1;    // its staged right columns
  const int base = x0 - offset - d0 - (dn - 1);  // column of element 0
  const size_t row = static_cast<size_t>(y) * W * Words;

  for (int i = threadIdx.x; i < Words * kTX; i += kThreads) {
    const int c = i / Words, w = i - c * Words;
    const int x = x0 + c;
    left_codes[w][c] =
        x < W ? static_cast<unsigned>(codes_left[row + x * Words + w]) : 0u;
  }
  for (int i = threadIdx.x; i < Words * span; i += kThreads) {
    const int j = i / Words, w = i - j * Words;
    const int x = base + j;
    const unsigned v =
        (x >= 0 && x < W) ? static_cast<unsigned>(
                                codes_right[row + x * Words + w])
                          : 0u;
#pragma unroll
    for (int s = 0; s < 4; ++s) right_codes[s][w][j + 3 + s] = v;
  }
  __syncthreads();

  const int groups = (dn + 3) / 4;
  for (int i = threadIdx.x; i < kTX * groups; i += kThreads) {
    const int c = i / groups, dl = 4 * (i - c * groups);
    const int x = x0 + c;
    if (x >= W) break;  // i only grows, and c with it
    // Disparity dl + k reads the right code at element j - k.
    const int j = c - dl + dn - 1;
    const int s = (-j) & 3;
    int h[4] = {0, 0, 0, 0};
#pragma unroll
    for (int w = 0; w < Words; ++w) {
      const unsigned l = left_codes[w][c];
      const uint4 r =
          *reinterpret_cast<const uint4*>(&right_codes[s][w][j + s]);
      h[0] += __popc(l ^ r.w);
      h[1] += __popc(l ^ r.z);
      h[2] += __popc(l ^ r.y);
      h[3] += __popc(l ^ r.x);
    }
    const int d = d0 + dl;
    const bool ok[4] = {x >= d + offset, x >= d + 1 + offset,
                        x >= d + 2 + offset, x >= d + 3 + offset};
    O* const dst = out + (static_cast<size_t>(y) * W + x) * D + d;
    if (vec) {
      Cells<O>::four(dst, h, ok);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (dl + k < dn) dst[k] = Cells<O>::of(h[k], ok[k]);
      }
    }
  }
}

int words_of(int win_w, int win_h) {
  return (win_w * win_h - 1 + 31) / 32;
}

template <int Words>
int launch_codes(const void* left, const void* right, void* codes_left,
                 void* codes_right, int H, int W, int win_w, int win_h,
                 cudaStream_t stream) {
  const int strips = (W + kCodeTX - 1) / kCodeTX;
  const long long blocks =
      static_cast<long long>(strips) * ((H + kCodeTY - 1) / kCodeTY);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (kCodeTX + win_w - 1) *
                      (kCodeTY + win_h - 1);
  census_codes_kernel<Words>
      <<<dim3(static_cast<unsigned>(blocks), 1, 2), dim3(kCodeTX, kCodeTY),
         smem, stream>>>(static_cast<const float*>(left),
                         static_cast<const float*>(right),
                         static_cast<int*>(codes_left),
                         static_cast<int*>(codes_right), H, W, win_w, win_h,
                         strips);
  return static_cast<int>(cudaGetLastError());
}

template <typename O, int Words>
int launch_hamming(const void* codes_left, const void* codes_right,
                   void* out, int H, int W, int D, int offset,
                   cudaStream_t stream) {
  const int strips = (W + kTX - 1) / kTX;
  const long long blocks = static_cast<long long>(strips) * H;
  const int chunks = (D + kDC - 1) / kDC;
  if (blocks > INT_MAX || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec =
      D % 4 == 0 &&
      reinterpret_cast<std::uintptr_t>(out) % (4 * sizeof(O)) == 0;
  census_hamming_kernel<Words, O>
      <<<dim3(static_cast<unsigned>(blocks), chunks), kThreads, 0, stream>>>(
          static_cast<const int*>(codes_left),
          static_cast<const int*>(codes_right), static_cast<O*>(out), H, W,
          D, offset, strips, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int hamming(const void* codes_left, const void* codes_right, void* out,
            int H, int W, int D, int words, int offset, void* stream) {
  if (H < 1 || W < 1 || D < 1 || offset < 0 || words < 1 ||
      words > kMaxWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1:
      return launch_hamming<O, 1>(codes_left, codes_right, out, H, W, D,
                                  offset, s);
    case 2:
      return launch_hamming<O, 2>(codes_left, codes_right, out, H, W, D,
                                  offset, s);
    case 3:
      return launch_hamming<O, 3>(codes_left, codes_right, out, H, W, D,
                                  offset, s);
    case 4:
      return launch_hamming<O, 4>(codes_left, codes_right, out, H, W, D,
                                  offset, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// float32 images [H, W] into int32 codes [H, W, words] each, words =
// ceil((win_w * win_h - 1) / 32), 1 to 4; both windows' sides odd.
extern "C" int stm_census_codes(const void* left, const void* right,
                                void* codes_left, void* codes_right, int H,
                                int W, int win_w, int win_h, void* stream) {
  if (H < 1 || W < 1 || win_w < 1 || win_h < 1 || win_w % 2 == 0 ||
      win_h % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (words_of(win_w, win_h)) {
    case 1:
      return launch_codes<1>(left, right, codes_left, codes_right, H, W,
                             win_w, win_h, s);
    case 2:
      return launch_codes<2>(left, right, codes_left, codes_right, H, W,
                             win_w, win_h, s);
    case 3:
      return launch_codes<3>(left, right, codes_left, codes_right, H, W,
                             win_w, win_h, s);
    case 4:
      return launch_codes<4>(left, right, codes_left, codes_right, H, W,
                             win_w, win_h, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The Hamming volume [H, W, D] of two images' int32 codes [H, W, words].
extern "C" int stm_census_hamming_f32(const void* codes_left,
                                      const void* codes_right, void* out,
                                      int H, int W, int D, int words,
                                      int offset, void* stream) {
  return hamming<float>(codes_left, codes_right, out, H, W, D, words, offset,
                        stream);
}

extern "C" int stm_census_hamming_i32(const void* codes_left,
                                      const void* codes_right, void* out,
                                      int H, int W, int D, int words,
                                      int offset, void* stream) {
  return hamming<int>(codes_left, codes_right, out, H, W, D, words, offset,
                      stream);
}

extern "C" int stm_census_hamming_bf16(const void* codes_left,
                                       const void* codes_right, void* out,
                                       int H, int W, int D, int words,
                                       int offset, void* stream) {
  return hamming<__nv_bfloat16>(codes_left, codes_right, out, H, W, D, words,
                                offset, stream);
}
