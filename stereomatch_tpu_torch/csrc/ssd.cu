// Windowed SSD / SAD cost volume [H, W, D] for Hopper (sm_90a).
//
// Replaces: stereomatch_tpu/ops/ssd_pallas.py, _cost_kernel (entered
// through diff_cost_volume_pallas).  The TPU kernel kept a 2k-row
// running-sum ring in VMEM and took the kernel only at D <= 64 with W a
// multiple of 128; this kernel serves every geometry.
//
// Semantics (plain version: stereomatch_tpu_torch/ops/cost.py):
//   cost[h, w, d] = sum over columns c in [w-k, w+k), clipped to [d, W),
//                   of V[h, c, d],
//   V[h, c, d]    = sum over rows r in [h-k, h+k), clipped to [0, H),
//                   of (L[r, c] - R[r, c - d])^2   (|.| for SAD),
//   cost = +inf (INT_MAX for the int32 chain) where w < d.
// The sums keep the plain version's association: rows first, in window
// order, then columns in window order, each starting from zero.  The
// float chain rounds every product and sum on its own (__fmul_rn /
// __fadd_rn, and -fmad=false), so it equals the plain version bit for
// bit; the int32 chain wraps like the reference's int32 arithmetic.
//
// What bounds it on an H100: the output write, H*W*D*4 bytes (86.4 MB
// at teddy 375x450 D=128, 1.34 GB at HD 1024x1280 D=256), against the
// taps: a direct window costs 4k^2 taps per output.  Design: one block
// owns one row h, kTileW output columns and blockDim.x disparities (one
// per thread).  Each thread first forms the vertical sums V for the
// kTileW + 2k - 1 columns its outputs read, into its own column of shared
// memory, then each output adds 2k of them: (kTileW + 2k - 1) * 2k /
// kTileW + 2k taps per output (34 at k=7) instead of 196.  Threads own
// disjoint shared-memory columns, so no barrier is needed.  Consecutive
// threads write consecutive d, so the stores are coalesced; the image
// reads are small and stay in L1/L2.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;

template <typename T>
struct Chain;

template <>
struct Chain<float> {
  static __device__ __forceinline__ float term(float a, float b,
                                               bool absolute) {
    const float diff = __fsub_rn(a, b);
    return absolute ? fabsf(diff) : __fmul_rn(diff, diff);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float fill() {
    return __int_as_float(0x7f800000);  // +inf
  }
};

// int32 chain in unsigned arithmetic: two's-complement wraparound is
// defined there, and it is what XLA's (and torch's) int32 ops do.
template <>
struct Chain<int> {
  static __device__ __forceinline__ int term(int a, int b, bool absolute) {
    const unsigned diff = static_cast<unsigned>(a) - static_cast<unsigned>(b);
    if (absolute) {
      return static_cast<int>(diff) < 0 ? static_cast<int>(0u - diff)
                                        : static_cast<int>(diff);
    }
    return static_cast<int>(diff * diff);
  }
  static __device__ __forceinline__ int add(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
  static __device__ __forceinline__ int fill() { return INT_MAX; }
};

template <typename T>
__global__ void ssd_kernel(const T* __restrict__ left,
                           const T* __restrict__ right, T* __restrict__ out,
                           int H, int W, int D, int k, bool absolute) {
  extern __shared__ unsigned char smem_raw[];
  T* vsum = reinterpret_cast<T*>(smem_raw);  // [kTileW + 2k - 1][blockDim.x]
  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int w0 = blockIdx.x * kTileW;
  const int d = blockIdx.z * blockDim.x + tid;
  const int span = kTileW + 2 * k - 1;
  const int r_lo = max(h - k, 0);
  const int r_hi = min(h + k, H);

  // Vertical window sums of the columns [w0 - k, w0 + kTileW + k - 1).
  // Columns outside [d, W) are the zero-masked wedge or the zero pad.
  for (int j = 0; j < span; ++j) {
    const int c = w0 - k + j;
    T v = T(0);
    if (d < D && c >= d && c < W) {
      for (int r = r_lo; r < r_hi; ++r) {
        v = Chain<T>::add(
            v, Chain<T>::term(left[r * W + c], right[r * W + c - d],
                              absolute));
      }
    }
    vsum[j * blockDim.x + tid] = v;
  }
  if (d >= D) return;

  // Horizontal window: output column w reads vsum rows i .. i + 2k - 1.
  for (int i = 0; i < kTileW; ++i) {
    const int w = w0 + i;
    if (w >= W) break;
    T acc = Chain<T>::fill();
    if (w >= d) {
      acc = T(0);
      for (int s = 0; s < 2 * k; ++s) {
        acc = Chain<T>::add(acc, vsum[(i + s) * blockDim.x + tid]);
      }
    }
    out[(static_cast<size_t>(h) * W + w) * D + d] = acc;
  }
}

template <typename T>
int launch_ssd(const void* left, const void* right, void* out, int H, int W,
               int D, int k, int absolute, void* stream) {
  const int threads = D > 32 ? 64 : 32;
  const dim3 grid((W + kTileW - 1) / kTileW, H, (D + threads - 1) / threads);
  const size_t smem =
      static_cast<size_t>(kTileW + 2 * k - 1) * threads * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<T*>(out), H, W, D, k, absolute != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stm_ssd_f32(const void* left, const void* right, void* out,
                           int H, int W, int D, int k, int absolute,
                           void* stream) {
  return launch_ssd<float>(left, right, out, H, W, D, k, absolute, stream);
}

extern "C" int stm_ssd_i32(const void* left, const void* right, void* out,
                           int H, int W, int D, int k, int absolute,
                           void* stream) {
  return launch_ssd<int>(left, right, out, H, W, D, k, absolute, stream);
}
