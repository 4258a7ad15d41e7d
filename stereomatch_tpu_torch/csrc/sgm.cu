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
// All three kernels walk straight pixel paths with the same device function,
// sgm_path, the design of the reference's semiglobal_gpu.cu: one warp per
// path, the [D] carry in registers (lane l holds d = l*VPL .. l*VPL+VPL-1),
// min over D by warp shuffles, and out (+)= L in place.  The TPU kernels'
// W-on-grid layouts, zero-row padding and transposed P2 maps were VMEM
// workarounds and have no counterpart here.
//
// Semantics (plain version: stereomatch_tpu_torch/ops/aggregation.py, the
// XLA scan's association, stereomatch_tpu/ops/aggregation.py:107-138):
//   at a path start (its predecessor lies outside the image): L = C;
//   elsewhere, with prev = L at the predecessor and m = min_d prev:
//     P2' = max(P1, P2 / |I(p) - I(pred)|)      (|dI| = 0 gives +inf)
//     n   = prev - m
//     L   = C + min(n[d], n[d-1] + P1, n[d+1] + P1, P2')  (+inf off-band)
// Every operation is one IEEE-rounded sub/add/div (explicit _rn
// intrinsics, -fmad=false) or an exact min/max that lets NaN through like
// jnp.minimum/torch.minimum, so L equals the plain version bit for bit.
// One launch per traversal, in the plain version's order, fixes the order
// of the accumulation into out.
//
// The chunk kernel (plain version: ops/aggregation.py::
// sweep_chunk_with_carry) is sgm_path with WITH_CARRY set, a compile-time
// flag, so the instantiations of the two whole-image kernels are the code
// they were.  A path that enters through the chunk's first row in scan
// order continues the path of its predecessor pixel (y - dy, x - dx) in
// the row before the chunk: its first step takes prev = carry[x - dx] and
// the intensity carry_image[x - dx] instead of L = C.  Where x - dx falls
// outside [0, W) (the diagonal's entry column) or seed is set (the first
// chunk in scan order) it starts with L = C, and so does every path that
// enters through the side column.  Each path whose last pixel lies on the
// chunk's last row in scan order writes its L there into carry_out[x];
// every column of that row ends exactly one path.  The TPU kernel fused
// the three row families into one [F, W, D] carry to save VMEM passes;
// here one launch covers one traversal of one chunk, and its [W, D] carry
// is read once and written once.
//
// What bounds it on an H100: the recurrence is sequential along a path,
// and a traversal has only W, H or W+H-1 paths (450-824 warps at teddy),
// a few warps per SM, so each step's latency (cost load, shuffle-min,
// read-modify-write of out) bounds it, not bandwidth (each traversal
// moves 3 * H*W*D*4 bytes, 259 MB at teddy).  The design hides what it
// can: the next step's cost and out values are loaded before the current
// step's shuffle-min, which does not depend on them.  A chunk launch has
// the same W or W+Hc-1 warps over paths of at most Hc steps (75 at teddy
// in 5 row tiles): the same latency bound over fewer steps, paid once per
// chunk in launch and ramp-up.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
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

// Hand-off buffers of the chunk kernel: the carry [W, D] and intensities
// [W] of the row before the chunk in scan order (unread when seed is
// set), and the carry [W, D] of the chunk's last row.
struct Carry {
  const float* in;
  const float* image;
  float* out;
  bool seed;
};

template <int VPL, bool WITH_CARRY>
__device__ void sgm_path(const float* __restrict__ cost,
                         const float* __restrict__ image,
                         float* __restrict__ out, int H, int W, int D,
                         int dy, int dx, float p1, float p2, bool accumulate,
                         int path, Carry carry) {
  const int lane = threadIdx.x & 31;
  const int d0 = lane * VPL;
  const Path p = path_of(path, H, W, dy, dx);
  const long step = static_cast<long>(dy) * W + dx;  // in pixels
  long pix = static_cast<long>(p.y) * W + p.x;

  float c[VPL], o[VPL], prev[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const bool ok = d0 + j < D;
    c[j] = ok ? cost[pix * D + d0 + j] : inf_f();
    o[j] = (ok && accumulate) ? out[pix * D + d0 + j] : 0.0f;
  }
  float intensity = image[pix];
  float prev_int = 0.0f;

  // A path entering through the chunk's first row (the first W paths,
  // path_of) continues from the carry unless it seeds.
  bool from_carry = false;
  if constexpr (WITH_CARRY) {
    const int xp = p.x - dx;
    if (!carry.seed && path < W && xp >= 0 && xp < W) {
      from_carry = true;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        prev[j] = d0 + j < D ? carry.in[static_cast<long>(xp) * D + d0 + j]
                             : inf_f();
      }
      prev_int = carry.image[xp];
    }
  }

  for (int s = 0; s < p.len; ++s) {
    // Loads of the next pixel: independent of this step's recurrence.
    const long next = pix + step;
    const bool more = s + 1 < p.len;
    float cn[VPL], on[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const bool ok = more && d0 + j < D;
      cn[j] = ok ? cost[next * D + d0 + j] : inf_f();
      on[j] = (ok && accumulate) ? out[next * D + d0 + j] : 0.0f;
    }
    const float int_next = more ? image[next] : 0.0f;

    float L[VPL];
    if (s == 0 && !from_carry) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) L[j] = c[j];
    } else {
      float m = prev[0];
#pragma unroll
      for (int j = 1; j < VPL; ++j) m = nan_min(m, prev[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = nan_min(m, __shfl_xor_sync(kFullMask, m, off));
      }
      const float grad = fabsf(__fsub_rn(intensity, prev_int));
      const float p2_adj = nan_max(p1, __fdiv_rn(p2, grad));

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

#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int d = d0 + j;
      if (d < D) {
        out[pix * D + d] = accumulate ? __fadd_rn(o[j], L[j]) : L[j];
      }
      prev[j] = d < D ? L[j] : inf_f();
      c[j] = cn[j];
      o[j] = on[j];
    }
    prev_int = intensity;
    intensity = int_next;
    pix = next;
  }

  if constexpr (WITH_CARRY) {
    // prev holds L at the path's last pixel.
    const int y_end = p.y + dy * (p.len - 1);
    if (y_end == (dy > 0 ? H - 1 : 0)) {
      const long x_end = p.x + dx * (p.len - 1);
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (d0 + j < D) carry.out[x_end * D + d0 + j] = prev[j];
      }
    }
  }
}

template <int VPL>
__global__ void sgm_rows_kernel(const float* __restrict__ cost,
                                const float* __restrict__ image,
                                float* __restrict__ out, int H, int W, int D,
                                int dy, int dx, float p1, float p2,
                                bool accumulate) {
  const int path = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (path >= path_count(H, W, dy, dx)) return;  // whole warp leaves
  sgm_path<VPL, false>(cost, image, out, H, W, D, dy, dx, p1, p2, accumulate,
                       path, Carry{});
}

template <int VPL>
__global__ void sgm_horizontal_kernel(const float* __restrict__ cost,
                                      const float* __restrict__ image,
                                      float* __restrict__ out, int H, int W,
                                      int D, int dx, float p1, float p2,
                                      bool accumulate) {
  const int path = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (path >= H) return;
  sgm_path<VPL, false>(cost, image, out, H, W, D, 0, dx, p1, p2, accumulate,
                       path, Carry{});
}

template <int VPL>
__global__ void sgm_chunk_kernel(const float* __restrict__ cost,
                                 const float* __restrict__ image,
                                 float* __restrict__ out, int H, int W, int D,
                                 int dy, int dx, float p1, float p2,
                                 bool accumulate, Carry carry) {
  const int path = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (path >= path_count(H, W, dy, dx)) return;  // whole warp leaves
  sgm_path<VPL, true>(cost, image, out, H, W, D, dy, dx, p1, p2, accumulate,
                      path, carry);
}

enum class Kind { kRows, kHorizontal, kChunk };

template <int VPL>
void launch(Kind kind, const float* cost, const float* image, float* out,
            int H, int W, int D, int dy, int dx, float p1, float p2,
            bool accumulate, Carry carry, cudaStream_t stream) {
  const int paths = path_count(H, W, dy, dx);
  const int blocks = (paths + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = 32 * kWarpsPerBlock;
  switch (kind) {
    case Kind::kRows:
      sgm_rows_kernel<VPL><<<blocks, threads, 0, stream>>>(
          cost, image, out, H, W, D, dy, dx, p1, p2, accumulate);
      break;
    case Kind::kHorizontal:
      sgm_horizontal_kernel<VPL><<<blocks, threads, 0, stream>>>(
          cost, image, out, H, W, D, dx, p1, p2, accumulate);
      break;
    case Kind::kChunk:
      sgm_chunk_kernel<VPL><<<blocks, threads, 0, stream>>>(
          cost, image, out, H, W, D, dy, dx, p1, p2, accumulate, carry);
      break;
  }
}

int dispatch(Kind kind, const void* cost, const void* image, void* out,
             int H, int W, int D, int dy, int dx, float p1, float p2,
             int accumulate, Carry carry, void* stream) {
  // rows and chunk: dy in {-1, 1}, dx in {-1, 0, 1}; horizontal: dy == 0,
  // |dx| == 1.  A chunk that does not seed needs the incoming carry.
  const bool ok =
      kind == Kind::kHorizontal
          ? dy == 0 && (dx == 1 || dx == -1)
          : (dy == 1 || dy == -1) && dx >= -1 && dx <= 1 &&
                (kind != Kind::kChunk ||
                 (carry.out != nullptr &&
                  (carry.seed || (carry.in != nullptr &&
                                  carry.image != nullptr))));
  if (!ok || D < 1 || D > 32 * 16 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* c = static_cast<const float*>(cost);
  const auto* im = static_cast<const float*>(image);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool acc = accumulate != 0;
  if (D <= 32) {
    launch<1>(kind, c, im, o, H, W, D, dy, dx, p1, p2, acc, carry, s);
  } else if (D <= 64) {
    launch<2>(kind, c, im, o, H, W, D, dy, dx, p1, p2, acc, carry, s);
  } else if (D <= 128) {
    launch<4>(kind, c, im, o, H, W, D, dy, dx, p1, p2, acc, carry, s);
  } else if (D <= 256) {
    launch<8>(kind, c, im, o, H, W, D, dy, dx, p1, p2, acc, carry, s);
  } else {
    launch<16>(kind, c, im, o, H, W, D, dy, dx, p1, p2, acc, carry, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One traversal of the vertical or a diagonal family (step dy = +-1).
extern "C" int stm_sgm_rows_f32(const void* cost, const void* image,
                                void* out, int H, int W, int D, int dy,
                                int dx, float p1, float p2, int accumulate,
                                void* stream) {
  return dispatch(Kind::kRows, cost, image, out, H, W, D, dy, dx, p1, p2,
                  accumulate, Carry{}, stream);
}

// One traversal of the horizontal family (step dy = 0, dx = +-1).
extern "C" int stm_sgm_horizontal_f32(const void* cost, const void* image,
                                      void* out, int H, int W, int D, int dy,
                                      int dx, float p1, float p2,
                                      int accumulate, void* stream) {
  return dispatch(Kind::kHorizontal, cost, image, out, H, W, D, dy, dx, p1,
                  p2, accumulate, Carry{}, stream);
}

// One row traversal (dy = +-1) over a chunk of H rows with carry hand-off:
// carry [W, D] and carry_image [W] belong to the row before the chunk in
// scan order (ignored, and may be null, when seed is set); carry_out
// [W, D] receives the path costs of the chunk's last row in scan order.
extern "C" int stm_sgm_chunk_f32(const void* cost, const void* image,
                                 const void* carry, const void* carry_image,
                                 void* out, void* carry_out, int H, int W,
                                 int D, int dy, int dx, float p1, float p2,
                                 int seed, int accumulate, void* stream) {
  const Carry hand_off{static_cast<const float*>(carry),
                       static_cast<const float*>(carry_image),
                       static_cast<float*>(carry_out), seed != 0};
  return dispatch(Kind::kChunk, cost, image, out, H, W, D, dy, dx, p1, p2,
                  accumulate, hand_off, stream);
}
