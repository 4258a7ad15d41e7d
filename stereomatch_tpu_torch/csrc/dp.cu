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
//   d[W-1] = argmin_d acc[W-1, d] (ties to the lowest d)
//   d[w]   = clip(d[w+1] + ptr[w, d[w+1]], 0, D-1)
// One __fadd_rn per step after exact comparisons: equal to the plain
// version bit for bit.
//
// Layout: the cost volume [H, W, D] as it comes, pointers int8 [H, W, D]
// (no transpose), final costs [H, D], disparities int32 [H, W].
//
// What bounds it on an H100: by bytes, one read of the float32 volume and
// one write of the int8 pointers (108 MB at teddy 375x450 D=128: 0.032 ms
// at 3.35 TB/s); in fact the W-long dependency chain of each row.
// Forward design: one warp per row, its [D] accumulator in registers
// (lane l holds d = l + 32 j, j < J), the d +- 1 neighbours exchanged by
// shuffles, and the next column's costs loaded before the current
// column's step so the loads overlap the chain.  Backward: one thread per
// row does the argmin and the walk; its loads are W dependent bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

template <int J>
__global__ void dp_forward_kernel(const float* __restrict__ cost,
                                  int8_t* __restrict__ ptr,
                                  float* __restrict__ final_costs, int H,
                                  int W, int D) {
  const int h = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t row = static_cast<size_t>(h) * W * D;
  const float inf = pos_inf();

  float acc[J];
  float next[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int d = lane + 32 * j;
    acc[j] = d < D ? cost[row + d] : inf;
    if (d < D) ptr[row + d] = 0;
    next[j] = (d < D && W > 1) ? cost[row + D + d] : inf;
  }

  for (int w = 1; w < W; ++w) {
    float cur[J];
#pragma unroll
    for (int j = 0; j < J; ++j) cur[j] = next[j];
    if (w + 1 < W) {
      const float* c = cost + row + static_cast<size_t>(w + 1) * D;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int d = lane + 32 * j;
        next[j] = d < D ? c[d] : inf;
      }
    }
    int8_t* p = ptr + row + static_cast<size_t>(w) * D;
    float out[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int d = lane + 32 * j;
      // acc[d-1]: the lane below, or lane 31 of the register below.
      const float up = __shfl_up_sync(kFull, acc[j], 1);
      const float wrap_up = __shfl_sync(kFull, acc[j > 0 ? j - 1 : 0], 31);
      // acc[d+1]: the lane above, or lane 0 of the register above.
      const float dn = __shfl_down_sync(kFull, acc[j], 1);
      const float wrap_dn = __shfl_sync(kFull, acc[j + 1 < J ? j + 1 : j], 0);
      const float c1 = lane > 0 ? up : (j > 0 ? wrap_up : inf);
      const float c2 = acc[j];
      // Padding lanes (d >= D) hold +inf, so d = D-1 sees +inf above.
      const float c3 = lane < 31 ? dn : (j + 1 < J ? wrap_dn : inf);
      const bool take1 = c1 < c2 && c1 < c3;
      const bool take2 = c2 < c3;
      const float m = take1 ? c1 : (take2 ? c2 : c3);
      out[j] = d < D ? __fadd_rn(cur[j], m) : inf;
      if (d < D) p[d] = take1 ? int8_t(-1) : (take2 ? int8_t(0) : int8_t(1));
    }
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = out[j];
  }

#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int d = lane + 32 * j;
    if (d < D) final_costs[static_cast<size_t>(h) * D + d] = acc[j];
  }
}

__global__ void dp_backward_kernel(const int8_t* __restrict__ ptr,
                                   const float* __restrict__ final_costs,
                                   int* __restrict__ disp, int H, int W,
                                   int D) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  // argmin with torch.argmin's order: the first minimum, a NaN first.
  const float* f = final_costs + static_cast<size_t>(h) * D;
  int best = 0;
  float best_v = f[0];
  for (int d = 1; d < D; ++d) {
    const float v = f[d];
    if (best_v == best_v && (v < best_v || v != v)) {
      best_v = v;
      best = d;
    }
  }
  int* out = disp + static_cast<size_t>(h) * W;
  const int8_t* p = ptr + static_cast<size_t>(h) * W * D;
  int cur = best;
  out[W - 1] = cur;
  for (int w = W - 2; w >= 0; --w) {
    cur += p[static_cast<size_t>(w) * D + cur];
    cur = min(max(cur, 0), D - 1);
    out[w] = cur;
  }
}

template <int J>
void launch_forward(const void* cost, void* ptr, void* final_costs, int H,
                    int W, int D, cudaStream_t stream) {
  dp_forward_kernel<J><<<H, 32, 0, stream>>>(
      static_cast<const float*>(cost), static_cast<int8_t*>(ptr),
      static_cast<float*>(final_costs), H, W, D);
}

}  // namespace

// D <= 512 (16 registers per lane); the wrapper checks.
extern "C" int stm_dp_forward_f32(const void* cost, void* ptr,
                                  void* final_costs, int H, int W, int D,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) {
    launch_forward<1>(cost, ptr, final_costs, H, W, D, s);
  } else if (D <= 64) {
    launch_forward<2>(cost, ptr, final_costs, H, W, D, s);
  } else if (D <= 128) {
    launch_forward<4>(cost, ptr, final_costs, H, W, D, s);
  } else if (D <= 256) {
    launch_forward<8>(cost, ptr, final_costs, H, W, D, s);
  } else if (D <= 512) {
    launch_forward<16>(cost, ptr, final_costs, H, W, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stm_dp_backward(const void* ptr, const void* final_costs,
                               void* disp, int H, int W, int D,
                               void* stream) {
  const int threads = 128;
  dp_backward_kernel<<<(H + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ptr), static_cast<const float*>(final_costs),
      static_cast<int*>(disp), H, W, D);
  return static_cast<int>(cudaGetLastError());
}
