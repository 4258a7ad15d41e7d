// Guided-filter cost-volume aggregation (wedge path) for Hopper (sm_90a).
//
// Replaces: stereomatch_tpu/ops/cvf_pallas.py:105 _fused_wedge_ring_kernel,
// entered through guided_filter_wedge_pallas (full width, pallas_call at
// :493) and guided_filter_wedge_chunked_pallas (W chunks with 2r halos, for
// HD, :679).  The TPU kernel streamed rows through a VMEM ring with running
// (lead/lag) H sums and did both stages in one pass; running sums round
// differently from the plain version, so neither is kept here.
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
// each in window order from 0: the plain version's association (its zero
// pads add +0, which changes nothing).  Every operation rounds on its own
// (__fadd_rn, __fmul_rn, __fdiv_rn, and -fmad=false), except the four
// product-and-add pairs that the plain version fuses, as XLA does, which
// are __fmaf_rn here.  No window sum reuses another's partial sum.
//
// Two kernels, one template (cvf_kernel): the stats kernel reads the
// volume and writes a0 and b0 (float32 scratch volumes), the filter kernel
// reads a0 and b0 and writes q.  Each output needs 2 x 2 x (2r+1) window
// adds that no reuse may share (68 at r = 8) and five (stats) or two
// (filter) IEEE divisions; the function moves three volumes a kernel.
// PR 2's kernels re-read every vertical window tap from device memory,
// about 25 reads of each input element through L2 at r = 8.  This design
// reads each element from device memory about once and feeds every add
// from a register:
//
// * A block owns kTX output columns x TD disparities x CH output rows (a
//   chunk) and walks the chunk in groups of G rows.  Input rows stream
//   into a shared-memory ring of G + 2r rows of (kTX + 2r) columns x TD
//   by cp.async, coalesced 16-byte pieces where D % 4 == 0 and the volume
//   is 16-byte aligned, 4-byte pieces otherwise; rows and columns outside
//   the image are stored as zeros.  Group k + 1's rows are requested when
//   group k's vertical sums are done, into the slots of group k's first G
//   rows, with the epilogue's operands of group k + 1 (guide planes or
//   guide) into the second of two buffers.  Each input element leaves
//   device memory (kTX + 2r)(CH + 2r) / (kTX CH) times (1.5-2 at r = 8).
//   Disparity tiles are the grid's fastest axis, so the blocks that share
//   a 128-byte line of a row run together.
// * Vertical sums: one thread per (column, disparity) of the span reads
//   its column's G + 2r ring rows once each and adds every value into the
//   G window sums it belongs to (window_sums: a static ramp in, a counted
//   steady state, a static ramp out), so each add has its operand in a
//   register; the G vertical sums go to a second shared-memory buffer.
// * Horizontal sums: one thread per (row, XB columns, disparity) reads its
//   XB + 2r vertical sums once each the same way, then computes the
//   outputs' epilogue and stores them, TD disparities contiguous.
//
// What bounds it on an H100 (PERF.md §6, PR 7): the bytes and the issue
// of instructions in turn, not overlapped.  At HD, with the sums and the
// epilogue cut out, the staging alone takes 37% (stats) and 52% (filter)
// of each kernel's time, at 1.4x and 1.5x the time of its bytes at the
// card's 3.35 TB/s: a block has one group of rows in flight, during its
// horizontal pass only.  The vertical sums add 30% and 29% (some 15
// instructions a ring row for 8 adds: the loads, the guide product and
// the ring's wrap), the horizontal ones 7% and 1%, the epilogue's
// divisions 26% and 18%.  Larger G, wider or narrower tiles and a deeper
// ring were measured and lost: each cost occupancy or issue more than
// it saved.
//
// The tile shape follows from r in one function (tile_of): the first of
// kTiles whose ramps r allows (G, XB <= 2r + 2) and whose shared memory
// fits kSmemTarget (two blocks an SM), else the card's 227 KB.  At r = 8:
// G = 4, XB = 8, TD = 16 (stats, 93 KB, two blocks an SM) or 8 (filter,
// 73 KB, three).  A radius that fits no tile (r above 34 for the filter)
// is refused.  CH is cut from the image height so that the grid fills
// the card about four times over, never below 4r rows.
//
// bfloat16 storage (the _bf16 entry points): the stats kernel reads a bf16
// volume and the filter kernel writes q as bf16; a0, b0, the guide and
// every statistic stay float32, as in the plain version and XLA, which
// widen the volume and round q once at the end (ops/cvf.py:157,304).  The
// ring holds the bf16 values as they come, in half the bytes, and the
// vertical sums widen each as they load it; q is rounded to nearest even
// as it is stored, +inf staying +inf on the wedge.  16-byte copies of a
// bf16 volume need D % 8 == 0, TD % 8 == 0 and a 16-byte-aligned volume;
// otherwise (odd D, a view at an odd element offset) the block loads its
// ring values one by one, synchronously: cp.async copies no fewer than 4
// bytes, which could straddle a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kTX = 32;          // output columns of a block
constexpr int kSmemTarget = 110 * 1024;   // two blocks on an SM
constexpr int kSmemMax = 227 * 1024;
constexpr int kRefused = -1;     // returned for a radius that cannot fit

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// A volume element of type T as float32 and back (bf16: widened exactly,
// narrowed to nearest even).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T narrow(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// torch.clamp_min / jnp.maximum against a constant: NaN propagates.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// cp.async: an asynchronous copy from device to shared memory that the
// issuing thread waits for by commit group (as in sgm.cu).
__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// B consecutive window sums of two sequences: s[j] = sum of v(t) for t =
// j .. j + 2r, added in t order from 0, where load(t) gives v(t) of both
// sequences and is called for t = 0, 1, ..., B + 2r - 1 in turn.  Each
// v(t) is loaded once and added into every sum it belongs to.  Needs
// B <= 2r + 2, so that the ramp in (t < B - 1) ends before the first
// window does.
template <int B, typename Load>
__device__ __forceinline__ void window_sums(int r, Load load, float (&s1)[B],
                                            float (&s2)[B]) {
#pragma unroll
  for (int j = 0; j < B; ++j) {
    s1[j] = 0.0f;
    s2[j] = 0.0f;
  }
  float a, b;
#pragma unroll
  for (int t = 0; t < B - 1; ++t) {
    load(t, a, b);
#pragma unroll
    for (int j = 0; j <= t; ++j) {
      s1[j] = __fadd_rn(s1[j], a);
      s2[j] = __fadd_rn(s2[j], b);
    }
  }
#pragma unroll 4
  for (int t = B - 1; t <= 2 * r; ++t) {
    load(t, a, b);
#pragma unroll
    for (int j = 0; j < B; ++j) {
      s1[j] = __fadd_rn(s1[j], a);
      s2[j] = __fadd_rn(s2[j], b);
    }
  }
#pragma unroll
  for (int s = 1; s < B; ++s) {
    load(2 * r + s, a, b);
#pragma unroll
    for (int j = s; j < B; ++j) {
      s1[j] = __fadd_rn(s1[j], a);
      s2[j] = __fadd_rn(s2[j], b);
    }
  }
}

// Shared-memory layout of a block, in floats.  Ring row: the span's
// volume values (one volume of `in_bytes` elements for stats, float32 a0
// then b0 for the filter), S x TD each in (column, disparity) order,
// padded to 4 floats (vol), then the stats kernel's S guide values, padded
// to 4 floats.  The vertical-sum buffer: two statistics x
// G rows x SP columns x TD, SP = S rounded up to odd so that the rows a
// warp reads fall into different banks.  The epilogue's operands of a
// group's G output rows, in two buffers (groups k and k + 1): stats, hi1,
// lo1, hi2 and lo2 over the kTX columns and pd1 and pd2 over the TD
// disparities; filter, the guide.
struct Layout {
  int S, R, SP, vol, row, ring, vbuf, plane, pd;
  __host__ __device__ Layout(int r, int G, int TD, bool stats,
                             int in_bytes) {
    S = kTX + 2 * r;
    R = G + 2 * r;
    SP = S | 1;
    vol = (S * TD * (stats ? 1 : 2) * in_bytes + 15) / 16 * 4;
    row = vol + (stats ? (S + 3) / 4 * 4 : 0);
    ring = R * row;
    vbuf = 2 * G * SP * TD;
    pd = (stats ? 4 : 1) * G * kTX;          // offset of pd1 in a buffer
    plane = pd + (stats ? 2 * G * TD : 0);   // floats of one buffer
  }
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(ring + vbuf + 2 * plane) * sizeof(float);
  }
};

// Threads of a block: one a horizontal item (a row, XB columns and a
// disparity of a group).
template <int G, int XB, int TD>
constexpr int kBlock = G * (kTX / XB) * TD;

struct Args {
  const void* in1;     // stats: the volume (T); filter: a0
  const float* in2;    // filter: b0
  const float* guide;
  const float *hi1, *lo1, *hi2, *lo2, *pd1, *pd2;
  void* out1;          // stats: a0; filter: q (T)
  float* out2;         // stats: b0
  int H, W, D, r, off, CH;
  float eps;
  int vec;             // 16-byte pieces
};

// The element type a kernel stages (stats: the volume's T; filter: a0 and
// b0, float32) and the one it stores into out1 (stats: a0, float32;
// filter: q, T).
template <bool kStats, typename T>
using In = std::conditional_t<kStats, T, float>;
template <bool kStats, typename T>
using Out1 = std::conditional_t<kStats, float, T>;

// Ring rows n in [n0, n1): image row y0 - r + n into slot n % R; and the
// epilogue's operands of group `g` into buffer g % 2.  One commit group.
template <int NT, int G, int TD, bool kStats, typename T>
__device__ __forceinline__ void stage(const Args& a, const Layout& L,
                                      float* ring, float* planes, int n0,
                                      int n1, int g, int y0, int x0, int dz,
                                      int y_last) {
  using E = In<kStats, T>;
  const int tid = threadIdx.x;
  const int nvol = kStats ? 1 : 2;
  const int piece = a.vec ? 16 / static_cast<int>(sizeof(E)) : 1;
  // Pieces a column: TD / piece, a power of two.
  const int shift = __ffs(TD / piece) - 1;
  const int per_row = L.S << shift;
  for (int n = n0; n < n1; ++n) {
    const int y = y0 - a.r + n;
    if (y > y_last) break;           // no output row of the chunk reads it
    float* const dst_row = ring + (n % L.R) * L.row;
    const bool row_in = y >= 0 && y < a.H;
    for (int i = tid; i < per_row; i += NT) {
      const int c = i >> shift;
      const int d = (i - (c << shift)) * piece;
      const int x = x0 - a.r + c;
      const bool in = row_in && x >= 0 && x < a.W;
      const size_t src = (static_cast<size_t>(y) * a.W + x) * a.D + dz + d;
      for (int v = 0; v < nvol; ++v) {
        E* const dst =
            reinterpret_cast<E*>(dst_row) + v * L.S * TD + c * TD + d;
        const E* const base =
            v == 0 ? static_cast<const E*>(a.in1)
                   : reinterpret_cast<const E*>(a.in2);
        if (!in) {
          for (int k = 0; k < piece; ++k) dst[k] = narrow<E>(0.0f);
        } else if (dz + d < a.D) {
          if (a.vec) {
            copy16(reinterpret_cast<float*>(dst),
                   reinterpret_cast<const float*>(base + src));
          } else if constexpr (std::is_same<E, float>::value) {
            copy4(dst, base + src);
          } else {
            dst[0] = base[src];   // 2 bytes: loaded synchronously
          }
        }
      }
    }
    if (kStats) {
      float* const gr = dst_row + L.vol;
      for (int c = tid; c < L.S; c += NT) {
        const int x = x0 - a.r + c;
        if (row_in && x >= 0 && x < a.W) {
          copy4(gr + c, a.guide + static_cast<size_t>(y) * a.W + x);
        } else {
          gr[c] = 0.0f;
        }
      }
    }
  }
  // Entries outside the image are left as they are: no output reads them.
  float* const buf = planes + (g % 2) * L.plane;
  const int yg = y0 + g * G;
  for (int i = tid; i < L.pd; i += NT) {
    const int p = i / (G * kTX);
    const int j = (i / kTX) % G;
    const int x = x0 + i % kTX;
    if (yg + j < a.H && x < a.W) {
      const size_t pix = static_cast<size_t>(yg + j) * a.W + x;
      const float* const src = !kStats ? a.guide
                               : p == 0 ? a.hi1
                               : p == 1 ? a.lo1
                               : p == 2 ? a.hi2
                                        : a.lo2;
      copy4(buf + i, src + pix);
    }
  }
  if (kStats) {
    for (int i = tid; i < 2 * G * TD; i += NT) {
      const int j = (i / TD) % G;
      const int d = dz + i % TD;
      if (yg + j < a.H && d < a.D) {
        copy4(buf + L.pd + i,
              (i < G * TD ? a.pd1 : a.pd2) +
                  static_cast<size_t>(yg + j) * a.D + d);
      }
    }
  }
  commit_copies();
}

template <int G, int XB, int TD, bool kStats, typename T>
__global__ void __launch_bounds__(kBlock<G, XB, TD>)
    cvf_kernel(const Args a) {
  static_assert(kTX % XB == 0 && 32 % TD == 0, "tile shape");
  using E = In<kStats, T>;
  constexpr int NT = kBlock<G, XB, TD>;
  extern __shared__ __align__(16) float smem[];
  const Layout L(a.r, G, TD, kStats, sizeof(E));
  Out1<kStats, T>* const out1 = static_cast<Out1<kStats, T>*>(a.out1);
  float* const ring = smem;
  float* const ring_end = smem + L.ring;
  float* const vbuf = ring_end;
  float* const planes = vbuf + L.vbuf;
  const int tid = threadIdx.x;
  const int r = a.r;
  const int dz = blockIdx.x * TD;
  const int x0 = blockIdx.y * kTX;
  const int y0 = blockIdx.z * a.CH;
  const int y1 = min(y0 + a.CH, a.H);
  const int y_last = y1 - 1 + r;   // rows past H are staged as zeros
  const int groups = (y1 - y0 + G - 1) / G;
  const int vstat = G * L.SP * TD;   // floats of one statistic's sums

  stage<NT, G, TD, kStats, T>(a, L, ring, planes, 0, G + 2 * r, 0, y0, x0,
                              dz, y_last);
  // This thread's horizontal item: row j, columns xb * XB + [0, XB),
  // disparity d of the tile.
  const int hd = tid % TD;
  const int hj = (tid / TD) % G;
  const int hxb = tid / (TD * G);
  const int dd = dz + hd;
  const int dlo = dd + a.off;
  for (int k = 0; k < groups; ++k) {
    wait_copies<0>();
    __syncthreads();
    // Vertical sums of the group's G rows, for every span column.
    for (int i = tid; i < L.S * TD; i += NT) {
      const int c = i / TD;
      const int d = i % TD;
      // The column's next ring row (rows 0, 1, ... of the group in
      // turn); its value at element `at`, and its guide value.
      const float* p = ring + (k * G) % L.R * L.row;
      const int at = c * TD + d;
      auto load = [&](int, float& v1, float& v2) {
        const E* const vol = reinterpret_cast<const E*>(p);
        v1 = widen(vol[at]);
        if constexpr (kStats) {
          v2 = __fmul_rn(p[L.vol + c], v1);
        } else {
          v2 = vol[L.S * TD + at];
        }
        p += L.row;
        if (p >= ring_end) p -= L.ring;
      };
      float s1[G], s2[G];
      // Stats: a column on the wedge (x < d + off) holds p0 = 0 in every
      // row, so its sums are 0 + 0 + ... = +0.
      if (kStats && x0 - r + c < dz + d + a.off) {
#pragma unroll
        for (int j = 0; j < G; ++j) s1[j] = s2[j] = 0.0f;
      } else {
        window_sums<G>(r, load, s1, s2);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        vbuf[(j * L.SP + c) * TD + d] = s1[j];
        vbuf[vstat + (j * L.SP + c) * TD + d] = s2[j];
      }
    }
    __syncthreads();
    // The ring slots of this group's first G rows, and the buffer of
    // group k - 1's operands, are free: request group k + 1's, which land
    // while this group's horizontal sums run.  After the last group none
    // is requested, so no copy is in flight when the block exits.
    if (k + 1 < groups) {
      stage<NT, G, TD, kStats, T>(a, L, ring, planes, (k + 1) * G + 2 * r,
                                  (k + 2) * G + 2 * r, k + 1, y0, x0, dz,
                                  y_last);
    }
    // Horizontal sums and the epilogue of this thread's outputs.
    const float* const vrow = vbuf + (hj * L.SP + hxb * XB) * TD + hd;
    auto load = [&](int t, float& v1, float& v2) {
      v1 = vrow[t * TD];
      v2 = vrow[vstat + t * TD];
    };
    float s1[XB], s2[XB];
    window_sums<XB>(r, load, s1, s2);
    const int y = y0 + k * G + hj;
    if (y >= y1 || dd >= a.D) continue;
    const float* const buf = planes + (k % 2) * L.plane + hj * kTX + hxb * XB;
    const float ch =
        static_cast<float>(min(y + r, a.H - 1) - max(y - r, 0) + 1);
    const size_t first = (static_cast<size_t>(y) * a.W + x0 + hxb * XB) *
                             a.D + dd;
#pragma unroll
    for (int u = 0; u < XB; ++u) {
      const int x = x0 + hxb * XB + u;
      if (x >= a.W) continue;
      const size_t out = first + static_cast<size_t>(u) * a.D;
      const float cw = static_cast<float>(
          max(min(x + r, a.W - 1) - max(max(x - r, 0), dlo) + 1, 0));
      // max(countH * countW, 1), as the plain version computes it.
      const float count = max_nan(__fmul_rn(ch, cw), 1.0f);
      if constexpr (kStats) {
        if (x < dlo) {
          out1[out] = 0.0f;
          a.out2[out] = 0.0f;
          continue;
        }
        const bool cond = (x - r) >= dlo;
        const float* const pd = planes + (k % 2) * L.plane + L.pd +
                                hj * TD + hd;
        const float s_g = __fsub_rn(buf[u], cond ? buf[G * kTX + u] : pd[0]);
        const float s_gg = __fsub_rn(buf[2 * G * kTX + u],
                                     cond ? buf[3 * G * kTX + u]
                                          : pd[G * TD]);
        const float mean_p = __fdiv_rn(s1[u], count);
        const float mean_i = __fdiv_rn(s_g, count);
        const float corr_ip = __fdiv_rn(s2[u], count);
        const float corr_ii = __fdiv_rn(s_gg, count);
        const float var_i =
            max_nan(__fmaf_rn(-mean_i, mean_i, corr_ii), 0.0f);
        const float cov_ip = __fmaf_rn(-mean_i, mean_p, corr_ip);
        const float av = __fdiv_rn(cov_ip, __fadd_rn(var_i, a.eps));
        out1[out] = av;
        a.out2[out] = __fmaf_rn(-av, mean_i, mean_p);
      } else {
        out1[out] = narrow<T>(
            x < dlo ? inf_f()
                    : __fmaf_rn(__fdiv_rn(s1[u], count), buf[u],
                                __fdiv_rn(s2[u], count)));
      }
    }
  }
}

// The tile of a radius: G rows a group, XB columns a horizontal thread,
// TD disparities a block (see the note at the top).  kTiles lists the
// candidates in order of preference; a radius takes the first whose ramps
// it allows (G, XB <= 2r + 2) and whose shared memory fits.
struct Tile {
  int G, XB, TD, index;
  size_t smem;
};

constexpr int kTiles[6][3] = {{4, 8, 16}, {4, 8, 8}, {4, 8, 4},
                              {2, 8, 4},  {4, 4, 16}, {2, 2, 16}};

bool tile_of(int r, bool stats, int in_bytes, Tile* t) {
  const int limits[2] = {kSmemTarget, kSmemMax};
  for (int limit : limits) {
    for (int i = 0; i < 6; ++i) {
      t->G = kTiles[i][0];
      t->XB = kTiles[i][1];
      t->TD = kTiles[i][2];
      t->index = i;
      t->smem = Layout(r, t->G, t->TD, stats, in_bytes).bytes();
      if (t->G <= 2 * r + 2 && t->XB <= 2 * r + 2 &&
          t->smem <= static_cast<size_t>(limit)) {
        return true;
      }
    }
  }
  return false;
}

template <int G, int XB, int TD, bool kStats, typename T>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = cvf_kernel<G, XB, TD, kStats, T>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err != 0) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = static_cast<int>(cudaGetDevice(&dev))) != 0) return err;
  if ((err = static_cast<int>(cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev))) != 0) {
    return err;
  }
  if ((err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kBlock<G, XB, TD>, smem))) != 0) {
    return err;
  }
  // Chunks of rows: enough blocks to fill the card about four times over,
  // never chunks shorter than 4r rows (their halo would be re-read more
  // than the chunk).
  const int tiles = ((a.W + kTX - 1) / kTX) * ((a.D + TD - 1) / TD);
  const int want = 4 * sms * std::max(per_sm, 1);
  int chunks = (want + tiles - 1) / tiles;
  chunks = std::min(chunks, std::max(1, a.H / std::max(4 * a.r, 4 * G)));
  Args b = a;
  b.CH = ((a.H + chunks - 1) / chunks + G - 1) / G * G;
  // 16-byte pieces of a column's TD values.
  b.vec = a.vec && TD * sizeof(In<kStats, T>) % 16 == 0;
  // Disparity tiles first: the blocks that share each 128-byte line of a
  // row run together.
  const dim3 grid((a.D + TD - 1) / TD, (a.W + kTX - 1) / kTX,
                  (a.H + b.CH - 1) / b.CH);
  cvf_kernel<G, XB, TD, kStats, T>
      <<<grid, kBlock<G, XB, TD>, smem, stream>>>(b);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStats, typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  // A radius either kernel refuses is refused by both, before any launch.
  Tile t, stats_tile, filter_tile;
  if (!tile_of(a.r, true, sizeof(T), &stats_tile) ||
      !tile_of(a.r, false, sizeof(float), &filter_tile)) {
    return kRefused;
  }
  t = kStats ? stats_tile : filter_tile;
  const size_t m = t.smem;
#define STM_TILE(i)                                               \
  case i:                                                         \
    return launch<kTiles[i][0], kTiles[i][1], kTiles[i][2], kStats, T>( \
        a, m, stream)
  switch (t.index) {
    STM_TILE(0);
    STM_TILE(1);
    STM_TILE(2);
    STM_TILE(3);
    STM_TILE(4);
    STM_TILE(5);
  }
#undef STM_TILE
  return kRefused;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <typename T>
int stats(const void* vol, const void* guide, const void* hi1,
          const void* lo1, const void* hi2, const void* lo2, const void* pd1,
          const void* pd2, void* a0, void* b0, int H, int W, int D, int r,
          int off, float eps, void* stream) {
  Args a{};
  a.in1 = vol;
  a.guide = static_cast<const float*>(guide);
  a.hi1 = static_cast<const float*>(hi1);
  a.lo1 = static_cast<const float*>(lo1);
  a.hi2 = static_cast<const float*>(hi2);
  a.lo2 = static_cast<const float*>(lo2);
  a.pd1 = static_cast<const float*>(pd1);
  a.pd2 = static_cast<const float*>(pd2);
  a.out1 = a0;
  a.out2 = static_cast<float*>(b0);
  a.H = H;
  a.W = W;
  a.D = D;
  a.r = r;
  a.off = off;
  a.eps = eps;
  a.vec = D % (16 / sizeof(T)) == 0 && aligned16(vol);
  return dispatch<true, T>(a, static_cast<cudaStream_t>(stream));
}

template <typename T>
int filter(const void* a0, const void* b0, const void* guide, void* q, int H,
           int W, int D, int r, int off, void* stream) {
  Args a{};
  a.in1 = a0;
  a.in2 = static_cast<const float*>(b0);
  a.guide = static_cast<const float*>(guide);
  a.out1 = q;
  a.H = H;
  a.W = W;
  a.D = D;
  a.r = r;
  a.off = off;
  a.vec = D % 4 == 0 && aligned16(a0) && aligned16(b0);
  return dispatch<false, T>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Stage 1: a float32 volume -> a0, b0 (float32).
extern "C" int stm_cvf_stats_f32(const void* vol, const void* guide,
                                 const void* hi1, const void* lo1,
                                 const void* hi2, const void* lo2,
                                 const void* pd1, const void* pd2, void* a0,
                                 void* b0, int H, int W, int D, int r,
                                 int off, float eps, void* stream) {
  return stats<float>(vol, guide, hi1, lo1, hi2, lo2, pd1, pd2, a0, b0, H, W,
                      D, r, off, eps, stream);
}

// Stage 1 of a bf16 volume; a0 and b0 float32.
extern "C" int stm_cvf_stats_bf16(const void* vol, const void* guide,
                                  const void* hi1, const void* lo1,
                                  const void* hi2, const void* lo2,
                                  const void* pd1, const void* pd2, void* a0,
                                  void* b0, int H, int W, int D, int r,
                                  int off, float eps, void* stream) {
  return stats<__nv_bfloat16>(vol, guide, hi1, lo1, hi2, lo2, pd1, pd2, a0,
                              b0, H, W, D, r, off, eps, stream);
}

// Stage 2: a0, b0 -> q (float32).
extern "C" int stm_cvf_filter_f32(const void* a0, const void* b0,
                                  const void* guide, void* q, int H, int W,
                                  int D, int r, int off, void* stream) {
  return filter<float>(a0, b0, guide, q, H, W, D, r, off, stream);
}

// Stage 2 with q rounded to bf16.
extern "C" int stm_cvf_filter_bf16(const void* a0, const void* b0,
                                   const void* guide, void* q, int H, int W,
                                   int D, int r, int off, void* stream) {
  return filter<__nv_bfloat16>(a0, b0, guide, q, H, W, D, r, off, stream);
}
