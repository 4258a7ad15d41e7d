// Guided-filter cost-volume aggregation (wedge path) for Hopper (sm_90a).
//
// Replaces: stereomatch_tpu/ops/cvf_pallas.py, _fused_wedge_ring_kernel,
// entered through guided_filter_wedge_pallas (full width) and
// guided_filter_wedge_chunked_pallas (W chunks with 2r halos, for HD).
// The TPU kernel streamed rows through a VMEM ring with running H sums
// and cut HD into W chunks to fit 16 MB of VMEM; neither constraint
// exists here, so one design serves every geometry.
//
// Semantics (plain version: stereomatch_tpu_torch/ops/cvf.py), for a
// volume whose invalid cells are exactly the wedge x < d + off:
//   p0 = valid ? p : 0; s_p = box(p0); s_gp = box(I * p0)
//   s_g, s_gg from the guide's prefix planes (computed outside, in
//   PyTorch, as the TPU version computes them in XLA outside its kernel)
//   count = max(countH(y) * countW(x, d), 1)
//   (a, b) = the guided filter's linear model of the four means
//   a0, b0 = valid ? (a, b) : 0
//   q = (box(a0) / count) * I + box(b0) / count; +inf where invalid.
// box is the clipped symmetric (2r+1)^2 window sum, H first and then W,
// each in window order: the plain version's association.  Every
// operation rounds on its own (__fadd_rn, __fmul_rn, __fdiv_rn, and
// -fmad=false), except the four product-and-add pairs that the plain
// version fuses, as XLA does, which are __fmaf_rn here.
//
// Two kernels: cvf_stats_kernel writes a0 and b0 (two float32 volumes of
// scratch), cvf_filter_kernel writes q.  What bounds them on an H100:
// the volume bytes (one read and one write of H*W*D*4: 86.4 MB each at
// teddy 375x450 D=128) against the window taps.  Design, as in ssd.cu:
// one block owns one row y, kTileW output columns and blockDim.x
// disparities (one per thread, so loads and stores are coalesced along
// D).  Each thread first forms the vertical (H) window sums of the
// kTileW + 2r columns its outputs read into its own column of shared
// memory (2r+1 taps each), then each output adds 2r+1 of them: about
// (kTileW + 2r)(2r+1)/kTileW + 2r+1 taps per output and statistic (43 at
// r = 8) instead of (2r+1)^2 = 289.  Threads own disjoint shared columns,
// so no barrier is needed.  The vertical taps of neighbouring rows and
// tiles overlap; they are served by L2, not by device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;

// torch.clamp_min / jnp.maximum against a constant: NaN propagates.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Clipped window counts as the plain version computes them.
__device__ __forceinline__ float window_count(int y, int x, int dlo, int H,
                                              int W, int r) {
  const float ch = static_cast<float>(min(y + r, H - 1) - max(y - r, 0) + 1);
  const float cw = static_cast<float>(
      max(min(x + r, W - 1) - max(max(x - r, 0), dlo) + 1, 0));
  return max_nan(__fmul_rn(ch, cw), 1.0f);
}

// Vertical window sums of two statistics for the block's span of
// columns.  Stage 1 (kStats): the statistics are p0 and I * p0 of the
// volume; stage 2: a0 and b0.  Invalid columns (c < dlo) and columns
// outside the image sum to zero in the plain version: they are skipped.
template <bool kStats>
__device__ __forceinline__ void vertical_sums(
    const float* __restrict__ first, const float* __restrict__ second,
    const float* __restrict__ guide, float* vs1, float* vs2, int y, int x0,
    int d, int dlo, int H, int W, int D, int r) {
  const int tid = threadIdx.x;
  const int span = kTileW + 2 * r;
  const int r_lo = max(y - r, 0);
  const int r_hi = min(y + r, H - 1);
  for (int j = 0; j < span; ++j) {
    const int c = x0 - r + j;
    float s1 = 0.0f;
    float s2 = 0.0f;
    if (d < D && c >= 0 && c < W && c >= dlo) {
      for (int row = r_lo; row <= r_hi; ++row) {
        const size_t idx = (static_cast<size_t>(row) * W + c) * D + d;
        if constexpr (kStats) {
          const float p = first[idx];
          s1 = __fadd_rn(s1, p);
          s2 = __fadd_rn(s2, __fmul_rn(guide[row * W + c], p));
        } else {
          s1 = __fadd_rn(s1, first[idx]);
          s2 = __fadd_rn(s2, second[idx]);
        }
      }
    }
    vs1[j * blockDim.x + tid] = s1;
    vs2[j * blockDim.x + tid] = s2;
  }
}

__global__ void cvf_stats_kernel(
    const float* __restrict__ vol, const float* __restrict__ guide,
    const float* __restrict__ hi1, const float* __restrict__ lo1,
    const float* __restrict__ hi2, const float* __restrict__ lo2,
    const float* __restrict__ pd1, const float* __restrict__ pd2,
    float* __restrict__ a0, float* __restrict__ b0, int H, int W, int D,
    int r, int off, float eps) {
  extern __shared__ float smem[];
  const int span = kTileW + 2 * r;
  float* vp = smem;
  float* vgp = smem + span * blockDim.x;
  const int tid = threadIdx.x;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTileW;
  const int d = blockIdx.z * blockDim.x + tid;
  const int dlo = d + off;
  vertical_sums<true>(vol, nullptr, guide, vp, vgp, y, x0, d, dlo, H, W, D,
                      r);
  if (d >= D) return;
  for (int i = 0; i < kTileW; ++i) {
    const int x = x0 + i;
    if (x >= W) break;
    const size_t pix = static_cast<size_t>(y) * W + x;
    const size_t out = pix * D + d;
    if (x < dlo) {
      a0[out] = 0.0f;
      b0[out] = 0.0f;
      continue;
    }
    float s_p = 0.0f;
    float s_gp = 0.0f;
    for (int s = 0; s <= 2 * r; ++s) {
      s_p = __fadd_rn(s_p, vp[(i + s) * blockDim.x + tid]);
      s_gp = __fadd_rn(s_gp, vgp[(i + s) * blockDim.x + tid]);
    }
    const bool cond = (x - r) >= dlo;
    const size_t col = static_cast<size_t>(y) * D + d;
    const float s_g = __fsub_rn(hi1[pix], cond ? lo1[pix] : pd1[col]);
    const float s_gg = __fsub_rn(hi2[pix], cond ? lo2[pix] : pd2[col]);
    const float count = window_count(y, x, dlo, H, W, r);
    const float mean_p = __fdiv_rn(s_p, count);
    const float mean_i = __fdiv_rn(s_g, count);
    const float corr_ip = __fdiv_rn(s_gp, count);
    const float corr_ii = __fdiv_rn(s_gg, count);
    const float var_i = max_nan(__fmaf_rn(-mean_i, mean_i, corr_ii), 0.0f);
    const float cov_ip = __fmaf_rn(-mean_i, mean_p, corr_ip);
    const float a = __fdiv_rn(cov_ip, __fadd_rn(var_i, eps));
    a0[out] = a;
    b0[out] = __fmaf_rn(-a, mean_i, mean_p);
  }
}

__global__ void cvf_filter_kernel(const float* __restrict__ a0,
                                  const float* __restrict__ b0,
                                  const float* __restrict__ guide,
                                  float* __restrict__ q, int H, int W, int D,
                                  int r, int off) {
  extern __shared__ float smem[];
  const int span = kTileW + 2 * r;
  float* va = smem;
  float* vb = smem + span * blockDim.x;
  const int tid = threadIdx.x;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTileW;
  const int d = blockIdx.z * blockDim.x + tid;
  const int dlo = d + off;
  vertical_sums<false>(a0, b0, nullptr, va, vb, y, x0, d, dlo, H, W, D, r);
  if (d >= D) return;
  for (int i = 0; i < kTileW; ++i) {
    const int x = x0 + i;
    if (x >= W) break;
    const size_t pix = static_cast<size_t>(y) * W + x;
    if (x < dlo) {
      q[pix * D + d] = __int_as_float(0x7f800000);  // +inf
      continue;
    }
    float sa = 0.0f;
    float sb = 0.0f;
    for (int s = 0; s <= 2 * r; ++s) {
      sa = __fadd_rn(sa, va[(i + s) * blockDim.x + tid]);
      sb = __fadd_rn(sb, vb[(i + s) * blockDim.x + tid]);
    }
    const float count = window_count(y, x, dlo, H, W, r);
    q[pix * D + d] = __fmaf_rn(__fdiv_rn(sa, count), guide[pix],
                               __fdiv_rn(sb, count));
  }
}

struct Launch {
  dim3 grid;
  int threads;
  size_t smem;
};

Launch launch_shape(int H, int W, int D, int r) {
  Launch l;
  l.threads = D > 32 ? 64 : 32;
  l.grid = dim3((W + kTileW - 1) / kTileW, H, (D + l.threads - 1) / l.threads);
  l.smem = static_cast<size_t>(kTileW + 2 * r) * l.threads * 2 * sizeof(float);
  return l;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

extern "C" int stm_cvf_stats_f32(const void* vol, const void* guide,
                                 const void* hi1, const void* lo1,
                                 const void* hi2, const void* lo2,
                                 const void* pd1, const void* pd2, void* a0,
                                 void* b0, int H, int W, int D, int r,
                                 int off, float eps, void* stream) {
  const Launch l = launch_shape(H, W, D, r);
  const int err = allow_smem(cvf_stats_kernel, l.smem);
  if (err != 0) return err;
  cvf_stats_kernel<<<l.grid, l.threads, l.smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol), static_cast<const float*>(guide),
      static_cast<const float*>(hi1), static_cast<const float*>(lo1),
      static_cast<const float*>(hi2), static_cast<const float*>(lo2),
      static_cast<const float*>(pd1), static_cast<const float*>(pd2),
      static_cast<float*>(a0), static_cast<float*>(b0), H, W, D, r, off,
      eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stm_cvf_filter_f32(const void* a0, const void* b0,
                                  const void* guide, void* q, int H, int W,
                                  int D, int r, int off, void* stream) {
  const Launch l = launch_shape(H, W, D, r);
  const int err = allow_smem(cvf_filter_kernel, l.smem);
  if (err != 0) return err;
  cvf_filter_kernel<<<l.grid, l.threads, l.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a0), static_cast<const float*>(b0),
      static_cast<const float*>(guide), static_cast<float*>(q), H, W, D, r,
      off);
  return static_cast<int>(cudaGetLastError());
}
