// K12: the re-encode transform of generated images, G's NCHW fp32 output in
// [-1, 1] -> ImageNet-normalised images at the re-ID size, NCHW in
// channels_last memory (the layout the encoder takes).
//
// Replaces: reid_gan_tpu/ops/transforms.py::diff_transform (:171-180), fused
// by XLA into the AE hard-mix train step (engine/gan_trainers.py:133):
//
//   x   = (g + 1) / 2
//   x   = jax.image.resize(x, (n, OH, OW, c), "bicubic")
//   out = (x - mean[c]) / std[c]
//
// The resize is scale_and_translate with the Keys cubic kernel (a = -0.5),
// not torch's bicubic (a = -0.75, clamped indices). For each output
// coordinate o along an axis of n inputs upsampled by s = OUT / n, the
// sample point is f = (o + 0.5) * (1 / s) - 0.5; the taps are the inputs
// i = floor(f) - 1 .. floor(f) + 2 with weight keys(|f - i|); the taps that
// fall outside [0, n) are dropped and the others divided by their sum
// (jax/_src/image/scale.py compute_weight_mat). At an exact 2x upsample the
// interior weights are (-3, 29, 111, -9) / 128 on inputs i-2 .. i+1 for
// output 2i, mirrored for 2i + 1, and the first and last three outputs are
// renormalised, e.g. output 0 takes (1.088235, -0.088235) on inputs 0, 1.
// The weights are formed here from the formula in JAX's order of
// operations, rounded (no contraction); each is exact at 2x except the
// renormalised ones, which are one IEEE division each. The halving of g + 1
// is a multiplication by 0.5, which gives the quotient exactly. The resize
// runs along H first, then W, as JAX's two contractions do; the
// normalisation gives the IEEE quotient, as K1's.
//
// Bound: bytes. At 16 images of 128x64 -> 256x128 it reads 1.57 MB and
// writes 6.29 MB, 2.3 us at 3.35 TB/s; one launch per hard-mix step, so the
// launch and one block's latency, not the bytes, are the floor. The design
// is separable, in shared memory, with each block's chain kept short:
// - A block takes one image's band of output rows (and a tile of output
//   columns: the whole row unless the shared memory forces tiles), so the
//   card holds 256-512 blocks at once; a 3D grid names them, no division.
// - It starts the copy of the input rows and columns the taps reach into
//   shared memory (16-byte cp.async), forms the band's row taps and its
//   columns' taps meanwhile (4 weights a row or column, not a pixel; no
//   branch: both cubic pieces are formed and one selected), runs the H pass
//   (4 taps of (g + 1) * 0.5, one fmaf chain from 0) into shared memory,
//   then the W pass (4 taps, the same), and normalises with the product
//   that gives the IEEE quotient (exact_div.cuh).
// - In the W pass a warp takes an output row, a lane every 32nd pixel, so
//   that the lanes read their taps and H-pass values side by side in shared
//   memory (no bank conflicts); the warp's 128 pixels go through a staging
//   row, so each store instruction writes 128 contiguous bytes of the
//   channels_last row (whole sectors).
// - The divisions that are rare at an upsample (a renormalised edge tap,
//   |v - mean| > 1) run out of line, and loops that need no unrolling stay
//   rolled: a block runs each instruction a few times, so the code's size
//   shows in its latency (scripts/torch_transform_probe.py --phases).
// - Each output is the parent's one-thread-a-pixel chain, term for term: a
//   tap outside the image has weight 0 (and its value is any staged one, as
//   the parent read input 0), so the bits are the same.
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "exact_div.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBand = 16;      // output rows a block, at most
constexpr int kWarps = kThreads / reid::kWarp;
constexpr int kUnitPixels = 4 * reid::kWarp;   // output pixels a warp stages at once
constexpr int kStaticSmem = kWarps * 3 * kUnitPixels * sizeof(float);   // the staging rows

// An IEEE division kept out of line: the paths that take it are rare (a
// renormalised tap, |v - mean| > 1), and the code stays small.
__device__ __noinline__ float ieee_div(float a, float b) { return __fdiv_rn(a, b); }

struct Norm {
  float mean[3], std[3];
  float inv[3];   // 1 / std, rounded to nearest
};

// (v - mean) / std, IEEE, of the values v[k] of channels k % 3: as a product
// corrected once (exact_div.cuh), which holds for |v - mean| <= 1, as it is
// for G's outputs in [-1, 1] (the cubic's weights of an axis add up to at
// most 1.25 in magnitude, so v lies in [-0.28, 1.28]); the values past it
// are divided again, on a branch the hot path does not take.
template <int kN>
__device__ __forceinline__ void normalise(float (&v)[kN], const Norm& nm) {
  float a[kN];
  bool far = false;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    a[k] = __fsub_rn(v[k], nm.mean[k % 3]);
    far |= fabsf(a[k]) > 1.0f;
    v[k] = reid::std_quotient(a[k], nm.std[k % 3], nm.inv[k % 3]);
  }
  if (far) {
#pragma unroll
    for (int k = 0; k < kN; ++k)
      if (fabsf(a[k]) > 1.0f) v[k] = ieee_div(a[k], nm.std[k % 3]);
  }
}

// The Keys cubic kernel with a = -0.5 at distance x >= 0, as
// jax/_src/image/scale.py _fill_keys_cubic_kernel computes it.
// Both pieces are formed and one selected, so the taps need no branch.
__device__ __forceinline__ float keys_cubic(float x) {
  const float outer = __fadd_rn(
      __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(-0.5f, x), 2.5f), x), 4.0f), x), 2.0f);
  const float inner =
      __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.5f, x), 2.5f), x), x), 1.0f);
  return x >= 2.0f ? 0.0f : (x >= 1.0f ? outer : inner);
}

// The sample point of output coordinate o.
__device__ __forceinline__ float sample(int o, float inv) {
  return __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f), inv), 0.5f);
}

// The first tap of output coordinate o (it may lie outside the image).
__device__ __forceinline__ int first_tap(int o, float inv) {
  return static_cast<int>(floorf(sample(o, inv))) - 1;
}

// The 4 taps and renormalised weights of output coordinate o along an axis
// of n inputs, the taps as offsets into the staged window [lo, lo + span):
// a tap outside [0, n) gets weight 0 and offset 0.
__device__ __forceinline__ void taps(int o, int n, float inv, int lo, int4* idx, float4* wgt) {
  const float f = sample(o, inv);
  const int base = static_cast<int>(floorf(f)) - 1;
  float w[4];
  int at[4];
  float total = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = base + t;
    const bool in = i >= 0 && i < n;
    w[t] = in ? keys_cubic(fabsf(__fsub_rn(f, static_cast<float>(i)))) : 0.0f;
    at[t] = in ? i - lo : 0;
    total = __fadd_rn(total, w[t]);
  }
  const bool keep = fabsf(total) > 1000.0f * 1.1920928955078125e-7f &&
                    f >= -0.5f && f <= static_cast<float>(n) - 0.5f;
#pragma unroll
  for (int t = 0; t < 4; ++t) w[t] = keep ? w[t] : 0.0f;
  if (keep && total != 1.0f) {   // renormalised (w / 1 is w: no division needed)
#pragma unroll
    for (int t = 0; t < 4; ++t) w[t] = ieee_div(w[t], total);
  }
  *idx = make_int4(at[0], at[1], at[2], at[3]);
  *wgt = make_float4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float half_up(float g) {   // (g + 1) / 2, exact
  return __fmul_rn(__fadd_rn(g, 1.0f), 0.5f);
}

// 4 taps in order, one fmaf chain from 0; of (g + 1) / 2 for the H pass
template <bool kHalfUp>
__device__ __forceinline__ float tap4(const float* v, int stride, int4 i, float4 w) {
  auto at = [&](int k) { return kHalfUp ? half_up(v[k * stride]) : v[k * stride]; };
  float t = 0.0f;
  t = fmaf(w.x, at(i.x), t);
  t = fmaf(w.y, at(i.y), t);
  t = fmaf(w.z, at(i.z), t);
  return fmaf(w.w, at(i.w), t);
}

struct Geometry {
  int H, W, OH, OW;
  int band, tile;                 // output rows and columns a block
  int rows_cap, cols_cap;         // the staged window's capacity
  float inv_h, inv_w;
  int vec_in;                     // 16-byte copies of whole rows
};

// Shared memory: row taps (band), column taps (tile), the staged window
// (3 x rows_cap x cols_cap) and the H pass (band x cols_cap x 3).
__host__ __device__ inline size_t smem_bytes(int band, int tile, int rows_cap, int cols_cap) {
  return static_cast<size_t>(band + tile) * 32 +
         sizeof(float) * 3 * (static_cast<size_t>(rows_cap) + band) * cols_cap;
}

__global__ void __launch_bounds__(kThreads)
diff_transform_kernel(const float* __restrict__ src, float* __restrict__ dst, Geometry geo,
                      Norm nm) {
  extern __shared__ float4 smem[];
  __shared__ float wstage[kWarps][3 * kUnitPixels];   // kStaticSmem
  int4* ridx = reinterpret_cast<int4*>(smem);
  float4* rw = reinterpret_cast<float4*>(ridx + geo.band);
  int4* cidx = reinterpret_cast<int4*>(rw + geo.band);
  float4* cw = reinterpret_cast<float4*>(cidx + geo.tile);
  float* stage = reinterpret_cast<float*>(cw + geo.tile);
  float* hpass = stage + 3 * geo.rows_cap * geo.cols_cap;
  const int H = geo.H, W = geo.W, cap = geo.cols_cap;
  const int lane = threadIdx.x % reid::kWarp, warp = threadIdx.x / reid::kWarp;

  const int n = blockIdx.z;   // the image; its band of rows, its tile of columns
  const int oy0 = blockIdx.y * geo.band, ox0 = blockIdx.x * geo.tile;
  const int nb = min(geo.band, geo.OH - oy0), nt = min(geo.tile, geo.OW - ox0);
  // the input window the band's and the tile's taps reach
  const int lo = max(0, first_tap(oy0, geo.inv_h));
  const int rows = min(H - 1, first_tap(oy0 + nb - 1, geo.inv_h) + 3) - lo + 1;
  const int xlo = max(0, first_tap(ox0, geo.inv_w));
  const int cols = min(W - 1, first_tap(ox0 + nt - 1, geo.inv_w) + 3) - xlo + 1;

  const float* img = src + static_cast<size_t>(n) * 3 * H * W;
  const bool whole = geo.vec_in && cols == W;
  if (whole) {
    // whole rows: each channel's window is one run of float4s, copied
    // while the taps are formed
    const int run4 = rows * W / 4;
    for (int c = 0; c < 3; ++c) {
      const float* in = img + (static_cast<size_t>(c) * H + lo) * W;
      float* out = stage + c * geo.rows_cap * cap;
#pragma unroll 1
      for (int k = threadIdx.x; k < run4; k += kThreads) reid::cp_async16(out + 4 * k, in + 4 * k, true);
    }
    reid::cp_async_commit();
  }
  for (int i = threadIdx.x; i < nb + nt; i += kThreads) {
    const bool row = i < nb;   // one call site: the code stays small
    taps(row ? oy0 + i : ox0 + i - nb, row ? H : W, row ? geo.inv_h : geo.inv_w, row ? lo : xlo,
         row ? ridx + i : cidx + i - nb, row ? rw + i : cw + i - nb);
  }
  if (whole) {
    reid::cp_async_wait<0>();
  } else {
    for (int row = warp; row < 3 * rows; row += kWarps) {
      const int c = row / rows, r = row - c * rows;
      const float* in = img + (static_cast<size_t>(c) * H + lo + r) * W + xlo;
      float* out = stage + (c * geo.rows_cap + r) * cap;
#pragma unroll 1
      for (int x = lane; x < cols; x += reid::kWarp) out[x] = __ldg(in + x);
    }
  }
  __syncthreads();

  // H pass: the band's rows at every staged column, a warp a row, the three
  // channels of a column side by side
  for (int r = warp; r < nb; r += kWarps) {
    const int4 i = ridx[r];
    const float4 w = rw[r];
    float* out = hpass + r * cap * 3;
#pragma unroll 1
    for (int x = lane; x < cols; x += reid::kWarp) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[3 * x + c] = tap4<true>(stage + c * geo.rows_cap * cap + x, cap, i, w);
    }
  }
  __syncthreads();

  // W pass: a warp a row, 128 pixels at a time, a lane every 32nd pixel,
  // so that the lanes' taps and H-pass values lie side by side in shared
  // memory; the 384 floats go through the warp's staging row, so that each
  // store instruction writes 128 contiguous bytes
  float* const out_stage = wstage[warp];
  for (int r = warp; r < nb; r += kWarps) {
    const float* h = hpass + r * cap * 3;
    float* o = dst + ((static_cast<size_t>(n) * geo.OH + oy0 + r) * geo.OW + ox0) * 3;
    for (int first = 0; first < nt; first += kUnitPixels) {
      constexpr int kPer = kUnitPixels / reid::kWarp;   // pixels a lane
      float v[3 * kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int px = min(first + p * reid::kWarp + lane, nt - 1);
        const int4 i = cidx[px];
        const float4 w = cw[px];
#pragma unroll
        for (int c = 0; c < 3; ++c) v[3 * p + c] = tap4<false>(h + c, 3, i, w);
      }
      normalise(v, nm);
#pragma unroll
      for (int p = 0; p < kPer; ++p)
#pragma unroll
        for (int c = 0; c < 3; ++c) out_stage[3 * (p * reid::kWarp + lane) + c] = v[3 * p + c];
      __syncwarp();
      const int valid = 3 * min(kUnitPixels, nt - first);
#pragma unroll
      for (int e = lane; e < 3 * kUnitPixels; e += reid::kWarp)
        if (e < valid) o[3 * first + e] = out_stage[e];
      __syncwarp();
    }
  }
}

// Output rows a block: the most (up to kMaxBand) that still gives every SM
// two blocks.
int pick_band(int N, int OH, int sms) {
  int band = kMaxBand;
  while (band > 1 && static_cast<long long>(N) * ((OH + band - 1) / band) < 2LL * sms)
    band /= 2;
  return band;
}

}  // namespace

// src: (N, 3, H, W) fp32 contiguous NCHW. dst: (N, 3, OH, OW) fp32 in
// channels_last memory, i.e. (N, OH, OW, 3) contiguous. OH >= H and
// OW >= W (an upsample: no antialias widening of the kernel); inv_h = H / OH
// and inv_w = W / OW as fp32. mean, std: the per-channel normalisation.
// Refuses (cudaErrorInvalidValue) an empty or downsampling shape and more
// than 65,535 images or bands of rows.
extern "C" int reid_diff_transform(const void* src, void* dst, int N, int H, int W,
                                   int OH, int OW, float inv_h, float inv_w,
                                   float m0, float m1, float m2, float s0, float s1,
                                   float s2, void* stream) {
  if (N < 1 || H < 1 || W < 1 || OH < H || OW < W) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  smem_max -= kStaticSmem;
  Geometry geo{H, W, OH, OW, 0, OW, 0, 0, inv_h, inv_w, 0};
  // the window of a band of b rows spans at most b + 4 inputs (an upsample
  // moves its first tap at most one input an output); one more for rounding
  auto fit = [&]() {
    geo.rows_cap = std::min(H, geo.band + 5);
    geo.cols_cap = std::min(W, geo.tile + 5);
    return smem_bytes(geo.band, geo.tile, geo.rows_cap, geo.cols_cap);
  };
  geo.band = pick_band(N, OH, sms);
  int tiles = 1;
  while (fit() > static_cast<size_t>(smem_max) && geo.band > 1) geo.band /= 2;
  while (fit() > static_cast<size_t>(smem_max) && geo.tile > 32) {
    geo.tile = (geo.tile + 1) / 2;
    tiles = (OW + geo.tile - 1) / geo.tile;
  }
  const size_t smem = fit();
  const int bands = (OH + geo.band - 1) / geo.band;
  if (smem > static_cast<size_t>(smem_max) || N > 65535 || bands > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  geo.vec_in = W % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (smem + kStaticSmem > 48 * 1024)   // past the default, the kernel must opt in
    cudaFuncSetAttribute(diff_transform_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const Norm nm = {{m0, m1, m2}, {s0, s1, s2}, {1.0f / s0, 1.0f / s1, 1.0f / s2}};
  diff_transform_kernel<<<dim3(tiles, bands, N), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), geo, nm);
  return reid::launch_status();
}
