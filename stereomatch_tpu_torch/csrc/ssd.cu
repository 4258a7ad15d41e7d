// Windowed SSD / SAD cost volume [H, W, D] for Hopper (sm_90a).
//
// Replaces: stereomatch_tpu/ops/ssd_pallas.py, _cost_kernel (entered
// through diff_cost_volume_pallas).  The TPU kernel kept a 2k-row
// running-sum ring in VMEM and took the kernel only at D <= 64 with W a
// multiple of 128; running sums round differently from the plain version,
// so none is kept here, and this kernel serves every geometry.
//
// Semantics (plain version: stereomatch_tpu_torch/ops/cost.py):
//   cost[h, w, d] = sum over columns c in [w-k, w+k), clipped to [d, W),
//                   of V[h, c, d],
//   V[h, c, d]    = sum over rows r in [h-k, h+k), clipped to [0, H),
//                   of (L[r, c] - R[r, c - d])^2   (|.| for SAD),
//   cost = +inf (INT_MAX for the int32 chain) where w < d.
// The sums keep the plain version's association: rows first, in window
// order, then columns in window order, each starting from zero (the plain
// version's zero pads add +0, which changes no sum of non-negative
// terms).  The float chain rounds every product and sum on its own
// (__fmul_rn / __fadd_rn, and -fmad=false), so it equals the plain version
// bit for bit; the int32 chain wraps like the reference's int32
// arithmetic.  No running sum and no tensor core: either would sum in
// another order.
//
// What bounds it on an H100: the function's bound is its output write,
// H*W*D*4 bytes (86.4 MB at teddy 375x450 D=128, 1.34 GB at HD 1024x1280
// D=256, 0.40 ms at 3.35 TB/s); exact window sums cost 2k adds for each
// vertical sum and 2k for each output, about 0.3 ms of float32 work at
// HD, k = 7.  A design of one output row, 32 columns and 64 disparities
// a block forms each term once for each of the 2k output rows whose window
// holds it, with two loads and the wedge test each time: its load
// instructions alone outweigh the bound (PERF.md §6).  This design forms
// each term once per block and keeps every window sum in registers:
//
// * A block owns G output rows x kTX (32) columns x TD disparities.  It
//   stages the rows [h0 - k, h0 + G + k - 1) of the left image over its
//   span of kTX + 2k - 1 columns, and of the right image over that span
//   shifted by its disparities, into shared memory: coalesced cp.async
//   copies, all in flight at once (the images, about 5 MB each at HD,
//   stay in L2); rows and columns outside the image are zero-filled.
// * Vertical sums: one thread per (span column, four disparities) forms
//   the terms of its column for each of the G + 2k - 1 rows once and adds
//   each into every one of the G vertical sums it belongs to (window_sums:
//   a static ramp in, a counted steady state, a static ramp out, in window
//   order from zero).  A term is 0 where c < d (the wedge) or c >= W,
//   selected, never by inf arithmetic.  The G sums go to shared memory.
// * Horizontal sums: one thread per (row, XB columns, four disparities)
//   reads its XB + 2k - 1 vertical sums once each (16-byte loads) and forms
//   its XB outputs the same way, then stores them: 16 bytes a thread where
//   D % 4 == 0 and the output is aligned, consecutive threads on
//   consecutive disparities.
//
// The tile follows from (k, D) in one function (tile_of): G and XB obey
// the ramp rule (<= 2k + 1); the block's shared memory aims at three or
// more blocks an SM, shrinking G, then TD.  Of 128, 256 and 384 threads,
// G = 4 or 8 and TD = 16 or 32, measured on an H100 (PERF.md §6), 128
// threads, G = 8 and TD = 32 were the fastest or within noise of it at
// teddy and HD.  Where even G = 1, TD = 4 cannot hold
// all 2k rows (k above about 40), the block streams its rows through RC
// staged rows, refilled between barriers, and forms the same sums.  A k
// for which not one staged row fits the card's 227 KB is refused before
// any launch.
//
// bfloat16 storage (stm_ssd_bf16): the float chain, then each output
// rounded once to nearest even as it is stored (the plain version's
// .to(torch.bfloat16), XLA's astype), +inf staying +inf; four bf16 outputs
// a thread leave as one 8-byte store where D % 4 == 0 and the output is
// 8-byte aligned.  Its bound is half the float32 one, 0.20 ms at HD.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

constexpr int kTX = 32;                 // output columns of a block
constexpr int kThreads = 128;           // threads of a block
constexpr int kSmemTarget = 74 * 1024;  // three blocks on an SM
constexpr int kSmemMax = 227 * 1024;
constexpr int kRefused = -1;            // returned for a k that cannot fit

template <typename T>
struct Chain;

template <>
struct Chain<float> {
  using Vec = float4;
  static __device__ __forceinline__ Vec vec(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float term(float a, float b,
                                               bool absolute) {
    const float diff = __fsub_rn(a, b);
    const float sq = __fmul_rn(diff, diff);
    return absolute ? fabsf(diff) : sq;
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
  using Vec = int4;
  static __device__ __forceinline__ Vec vec(const int (&v)[4]) {
    return make_int4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ int term(int a, int b, bool absolute) {
    const unsigned diff = static_cast<unsigned>(a) - static_cast<unsigned>(b);
    const unsigned mag = static_cast<int>(diff) < 0 ? 0u - diff : diff;
    return static_cast<int>(absolute ? mag : diff * diff);
  }
  static __device__ __forceinline__ int add(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
  static __device__ __forceinline__ int fill() { return INT_MAX; }
};

// cp.async of 4 bytes from device to shared memory, or of 4 zero bytes
// where `in` is false (src is then not read); the issuing thread waits for
// its copies with wait_copies.
__device__ __forceinline__ void copy4(void* dst, const void* src, bool in) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
          static_cast<unsigned>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(in ? 4 : 0)
      : "memory");
}
__device__ __forceinline__ void wait_copies() {
  asm volatile(
      "cp.async.commit_group;\n"
      "cp.async.wait_group 0;\n" ::
          : "memory");
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
  const auto x = *reinterpret_cast<const typename Chain<T>::Vec*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T (&v)[4]) {
  *reinterpret_cast<typename Chain<T>::Vec*>(p) = Chain<T>::vec(v);
}

// The stored type O of chain T: T itself, or bf16 from the float chain,
// rounded to nearest even.  four: four outputs at once (aligned to
// 4 * sizeof(O)); one: a single output.
template <typename T, typename O>
struct Out {
  static __device__ __forceinline__ void four(O* p, const T (&v)[4]) {
    store4(p, v);
  }
  static __device__ __forceinline__ void one(O* p, T v) { *p = v; }
};

template <>
struct Out<float, __nv_bfloat16> {
  static __device__ __forceinline__ void four(__nv_bfloat16* p,
                                              const float (&v)[4]) {
    *reinterpret_cast<uint2*>(p) = stm::narrow4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void one(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// B consecutive window sums of n terms, four disparities each:
// s[j][e] = sum of v(t)[e] for t = j .. j + n - 1, added in t order from
// 0, where load(t, v) gives v(t) and is called for t = 0, 1, ...,
// B + n - 2 in turn.  Each v(t) is loaded once and added into every sum it
// belongs to, so every add has its operand in a register.  Needs
// B <= n + 1, so that the ramp in (t < B - 1) ends before the first window
// does.
template <typename T, int B, typename Load>
__device__ __forceinline__ void window_sums(int n, Load load,
                                            T (&s)[B][4]) {
#pragma unroll
  for (int j = 0; j < B; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = T(0);
  }
  T v[4];
#pragma unroll
  for (int t = 0; t < B - 1; ++t) {
    load(t, v);
#pragma unroll
    for (int j = 0; j <= t; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = Chain<T>::add(s[j][e], v[e]);
    }
  }
#pragma unroll 2
  for (int t = B - 1; t < n; ++t) {
    load(t, v);
#pragma unroll
    for (int j = 0; j < B; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = Chain<T>::add(s[j][e], v[e]);
    }
  }
#pragma unroll
  for (int u = 1; u < B; ++u) {
    load(n - 1 + u, v);
#pragma unroll
    for (int j = u; j < B; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = Chain<T>::add(s[j][e], v[e]);
    }
  }
}

struct Args {
  const void* left;
  const void* right;
  void* out;
  int H, W, D, k;
  int TD;        // disparities of a block, a multiple of 4
  int RC;        // staged rows: all G + 2k - 1 of them, or a streamed few
  bool absolute;
  bool vec;      // four outputs a store (16 bytes float32, 8 bf16)
};

// Shared memory of a block, in elements: the vertical sums [G][S][TD],
// then RC staged rows of the left span [S] and of the right span
// [S + TD - 1], S = kTX + 2k - 1.
__host__ __device__ inline size_t smem_elems(int k, int G, int TD, int RC) {
  const size_t S = kTX + 2 * k - 1;
  return G * S * TD + RC * (2 * S + TD - 1);
}

// kStream: the block's window rows do not all fit; they pass through RC
// staged rows, refilled between barriers (G = 1).  T: the chain's type
// (images, sums); O: the stored type.
template <typename T, typename O, int G, int XB, bool kStream>
__global__ void __launch_bounds__(kThreads) ssd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* __restrict__ left = static_cast<const T*>(a.left);
  const T* __restrict__ right = static_cast<const T*>(a.right);
  O* __restrict__ out = static_cast<O*>(a.out);
  const int k = a.k, n = 2 * a.k, TD = a.TD, Q = a.TD / 4;
  const int S = kTX + n - 1;   // span columns: the vertical sums' columns
  const int SR = S + TD - 1;   // the right image's span
  const int R = G + n - 1;     // rows of the block's windows
  const int h0 = blockIdx.y * G;
  const int w0 = blockIdx.x * kTX;
  const int dz = blockIdx.z * TD;
  T* const vsum = reinterpret_cast<T*>(smem_raw);
  T* const ls = vsum + static_cast<size_t>(G) * S * TD;
  T* const rs = ls + static_cast<size_t>(a.RC) * S;

  // Window rows [t0, t0 + rows) into staged rows 0 .. rows - 1, every
  // copy in flight at once; zeros outside the image.
  auto stage = [&](int t0, int rows) {
    const int per_row = S + SR;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int row = i / per_row;
      const int col = i - row * per_row;
      const int y = h0 - k + t0 + row;
      const bool left_col = col < S;
      const int x =
          left_col ? w0 - k + col : w0 - k - dz - (TD - 1) + (col - S);
      const bool in = y >= 0 && y < a.H && x >= 0 && x < a.W;
      const T* const src = left_col ? left : right;
      copy4(left_col ? ls + row * S + col : rs + row * SR + (col - S),
            in ? src + static_cast<size_t>(y) * a.W + x : src, in);
    }
    wait_copies();
  };

  // Vertical sums: item (span column c, disparities dz + 4q .. + 3).
  if constexpr (!kStream) {
    stage(0, R);
    __syncthreads();
  }
  const int v_items = S * Q;
  for (int base = 0; base < v_items; base += kThreads) {
    const int item = base + threadIdx.x;
    const bool live = item < v_items;
    if (!live && !kStream) break;   // streaming: every thread meets the
                                    // barriers of every refill
    const int c = live ? item / Q : 0;
    const int q = live ? item - c * Q : 0;
    const int col = w0 - k + c;
    const int d = dz + 4 * q;
    bool ok[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) ok[e] = col >= d + e && col < a.W;
    const int u0 = c - 4 * q + TD - 1;   // right span column of (c, d)
    auto load = [&](int t, T (&v)[4]) {
      int slot = t;
      if constexpr (kStream) {
        slot = t % a.RC;
        if (slot == 0) {
          __syncthreads();
          stage(t, min(a.RC, R - t));
          __syncthreads();
        }
      }
      const T l = ls[slot * S + c];
      const T* const r = rs + slot * SR + u0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T term = Chain<T>::term(l, r[-e], a.absolute);
        v[e] = ok[e] ? term : T(0);
      }
    };
    T sums[G][4];
    window_sums<T, G>(n, load, sums);
    if (live) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        store4(vsum + (static_cast<size_t>(g) * S + c) * TD + 4 * q,
               sums[g]);
      }
    }
  }
  __syncthreads();

  // Horizontal sums: item (row g, columns XB*b .. + XB - 1, disparities
  // dz + 4q .. + 3); output column w reads span columns w - w0 .. + 2k - 1.
  const int per_row = (kTX / XB) * Q;
  for (int item = threadIdx.x; item < G * per_row; item += kThreads) {
    const int g = item / per_row;
    const int b = (item - g * per_row) / Q;
    const int q = item - g * per_row - b * Q;
    const int h = h0 + g;
    const int x0 = w0 + b * XB;
    if (h >= a.H || x0 >= a.W) continue;
    const T* const vrow =
        vsum + (static_cast<size_t>(g) * S + b * XB) * TD + 4 * q;
    auto load = [&](int t, T (&v)[4]) { load4(vrow + t * TD, v); };
    T sums[XB][4];
    window_sums<T, XB>(n, load, sums);
    const int d = dz + 4 * q;
#pragma unroll
    for (int j = 0; j < XB; ++j) {
      const int w = x0 + j;
      if (w >= a.W) break;
      T o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = w >= d + e ? sums[j][e] : Chain<T>::fill();
      }
      O* const dst = out + (static_cast<size_t>(h) * a.W + w) * a.D + d;
      if (a.vec) {
        if (d < a.D) Out<T, O>::four(dst, o);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (d + e < a.D) Out<T, O>::one(dst + e, o[e]);
        }
      }
    }
  }
}

// The (G, XB, kStream) shapes instantiated: XB is the largest of 8, 4, 2
// within the ramp rule, G shrinks from XB to 1; only a k of 4 or more
// (XB = 8) can need streamed rows.
constexpr int kShapes[][3] = {{8, 8, 0}, {4, 8, 0}, {2, 8, 0}, {1, 8, 0},
                              {4, 4, 0}, {2, 4, 0}, {1, 4, 0}, {2, 2, 0},
                              {1, 2, 0}, {1, 8, 1}};
constexpr int kNumShapes = sizeof(kShapes) / sizeof(kShapes[0]);
constexpr int kStreamShape = kNumShapes - 1;
static_assert(kShapes[kStreamShape][0] == 1 && kShapes[kStreamShape][2],
              "the last shape streams its rows at G = 1");

struct Tile {
  int shape;     // index into kShapes
  int TD, RC;
  size_t smem;   // bytes
};

// The tile of (k, D): the largest G (then TD) whose block holds all its
// rows within kSmemTarget; failing that, G = 1 and TD = 4 with as many
// streamed rows as fit kSmemTarget, or failing one row, the card's
// kSmemMax.  False if not one row fits.
bool tile_of(int k, int D, size_t elem, Tile* t) {
  const int ramp = 2 * k + 1;
  const int XB = ramp >= 8 ? 8 : ramp >= 4 ? 4 : 2;
  const int td_max = D >= 32 ? 32 : (D + 3) / 4 * 4;
  for (int step = 0; step < 4; ++step) {   // TD: td_max, then 16, 8, 4
    const int TD = step == 0 ? td_max : 32 >> step;
    if (step > 0 && TD >= td_max) continue;
    for (int i = 0; i < kStreamShape; ++i) {
      const int G = kShapes[i][0];
      if (kShapes[i][1] != XB || G > ramp || (TD < td_max && G > 1)) {
        continue;
      }
      const size_t bytes = smem_elems(k, G, TD, G + 2 * k - 1) * elem;
      if (bytes <= kSmemTarget) {
        *t = {i, TD, G + 2 * k - 1, bytes};
        return true;
      }
    }
  }
  if (XB != kShapes[kStreamShape][1]) return false;
  const size_t fixed = smem_elems(k, 1, 4, 0);
  const size_t per_row = smem_elems(k, 0, 4, 1);
  const size_t limits[] = {kSmemTarget, kSmemMax};
  for (const size_t limit : limits) {
    if (limit / elem >= fixed + per_row) {
      const int rc = static_cast<int>((limit / elem - fixed) / per_row);
      *t = {kStreamShape, 4, rc, smem_elems(k, 1, 4, rc) * elem};
      return true;
    }
  }
  return false;
}

template <typename T, typename O, int G, int XB, bool kStream>
int launch(const Args& a, const Tile& t, cudaStream_t stream) {
  auto kernel = ssd_kernel<T, O, G, XB, kStream>;
  if (t.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(t.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.W + kTX - 1) / kTX, (a.H + G - 1) / G,
                  (a.D + a.TD - 1) / a.TD);
  kernel<<<grid, kThreads, t.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O = T>
int launch_ssd(const void* left, const void* right, void* out, int H, int W,
               int D, int k, int absolute, void* stream) {
  if (H < 1 || W < 1 || D < 1 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tile t;
  if (!tile_of(k, D, sizeof(T), &t)) return kRefused;
  const Args a{left, right, out, H, W, D, k, t.TD, t.RC, absolute != 0,
               D % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) %
                                     (4 * sizeof(O)) == 0};
  const auto s = static_cast<cudaStream_t>(stream);
#define STM_SHAPE(i)                                              \
  case i:                                                         \
    return launch<T, O, kShapes[i][0], kShapes[i][1],              \
                  kShapes[i][2] != 0>(a, t, s)
  switch (t.shape) {
    STM_SHAPE(0);
    STM_SHAPE(1);
    STM_SHAPE(2);
    STM_SHAPE(3);
    STM_SHAPE(4);
    STM_SHAPE(5);
    STM_SHAPE(6);
    STM_SHAPE(7);
    STM_SHAPE(8);
    STM_SHAPE(9);
  }
#undef STM_SHAPE
  return kRefused;
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

// float32 images, the float chain, bf16 output.
extern "C" int stm_ssd_bf16(const void* left, const void* right, void* out,
                            int H, int W, int D, int k, int absolute,
                            void* stream) {
  return launch_ssd<float, __nv_bfloat16>(left, right, out, H, W, D, k,
                                          absolute, stream);
}
