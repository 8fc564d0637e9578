// K4: fused train augmentation, uint8 NHWC staging batch -> flip -> linear
// crop-resize -> ImageNet normalize -> random erasing with the per-image
// channel mean, as fp32 NCHW in channels_last memory (physically NHWC).
//
// Replaces: reid_gan_tpu/ops/transforms.py::reid_augment(train=True)
// (ops/transforms.py:152-157: random_hflip :59-62, random_sized_rect_crop
// :86-104 through jax.image.scale_and_translate, normalize :36-37,
// random_erasing :108-134), which XLA fused into the jitted train step. The
// random draws are made apart from this kernel (ops/transforms.py::
// sample_augment_params) and come in as ten fp32 values per image:
//   [flip, crop_top, crop_left, crop_h, crop_w,
//    erase_do, erase_top, erase_left, erase_h, erase_w].
//
// The crop follows scale_and_translate's linear ("triangle") kernel
// (jax/_src/image/scale.py:54-85) in fp32 and in its order of operations:
//   scale = out / crop, translation = -top * scale, inv = 1 / scale,
//   sample_f = (o + 0.5) * inv - translation * inv - 0.5,
//   w_i = max(0, 1 - |sample_f - i|), renormalised to sum 1,
//   zero where sample_f is outside [-0.5, size - 0.5].
// The staged image is already at the output size and the crop is never
// larger (transforms.py:97-102), so the filter always upsamples
// (kernel_scale = 1) and each output pixel has at most two taps per axis.
// Products and sums are written with __fmul_rn / __fadd_rn so nvcc does not
// contract them into FMAs that the JAX arithmetic does not have; the one FMA
// that XLA's compiled sample_f does have, (o + 0.5) * inv - translation * inv
// as fma(o + 0.5, inv, -(translation * inv)), is written out, so the weights
// equal the jitted reference's bit for bit. A pixel is
//   v = wy0 * (wx0 * t[y0][x0] + wx1 * t[y0][x1]) + wy1 * (wx0 * t[y1][x0] + wx1 * t[y1][x1])
// in that order, t = byte / 255, then (v - mean) / std.
//
// Bound: bytes. It reads each staged byte once and writes 4 bytes per value:
// 25.2 MB + 100.7 MB at batch 256 of 256x128, 0.038 ms at 3.35 TB/s. What
// the design does about it:
// - A block takes one band of kBands an image. Once a block it makes what
//   every pixel recomputed: the W column taps (taps(), with the flip folded
//   into the source offsets) and its rows' taps, in shared memory.
// - The source rows a chunk of output rows reads (at most chunk + 2, since
//   the crop upsamples) are staged into shared memory with 16-byte cp.async
//   copies (an image's rows are contiguous), the next chunk's during this
//   chunk's vertical pass.
// - The filter is separable in that order of operations: the bracketed row
//   sums depend on the source row and the output column only. A horizontal
//   pass makes them once per staged row; the vertical pass reads two of them
//   as float4s, normalises and writes whole float4s, streaming
//   (st.global.cs), a warp a row and a lane a float4, with no division by W.
// - No division is left per element: b / 255 and (v - mean) / std are
//   products with a rounded reciprocal corrected once by an fma, which give
//   the IEEE quotients bit for bit here (unit() and normalise() below).
// - The erase fill is the mean of the normalised crop. Each block sums its
//   band in a fixed order (thread, warp, block) into a scratch row; a second
//   launch, a block a band, adds the image's band sums in band order and
//   overwrites the rectangle. It is a programmatic dependent launch, which
//   hides its launch behind the first grid's tail. No float atomics: the
//   fill is the same on every run. (A cluster of the image's bands summing
//   through distributed shared memory in one launch ran slower: PERF.md.)
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "exact_div.cuh"

namespace {

constexpr int kBands = 8;       // blocks an image, a band of rows each
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * reid::kWarp;
constexpr int kChunkRows = 16;  // output rows staged at a time
constexpr int kParams = 10;
constexpr int kSmemDefault = 48 * 1024;  // the chunk shrinks to stay under it; above, opt in
constexpr int kSmemMax = 227 * 1024;

struct Norm {
  float mean[3];
  float std[3];
  float inv[3];  // 1 / std, rounded to nearest
};

struct Taps {
  int i0;       // first source index (may be -1 or size-1; w0/w1 are 0 there)
  float w0, w1;
};

// The linear filter's weights for one output coordinate, as
// compute_weight_mat forms them (scale.py:66-85).
__device__ __forceinline__ Taps taps(int o, float inv, float trans, int size) {
  const float f = __fsub_rn(__fmaf_rn(__fadd_rn(static_cast<float>(o), 0.5f), inv,
                                      -__fmul_rn(trans, inv)),
                            0.5f);
  Taps t;
  t.i0 = static_cast<int>(floorf(f));
  float w0 = fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(f, static_cast<float>(t.i0))));
  float w1 = fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(f, static_cast<float>(t.i0 + 1))));
  if (t.i0 < 0 || t.i0 >= size) w0 = 0.0f;
  if (t.i0 + 1 < 0 || t.i0 + 1 >= size) w1 = 0.0f;
  const float total = __fadd_rn(w0, w1);
  if (fabsf(total) > 1000.0f * 1.1920929e-07f) {
    w0 = __fdiv_rn(w0, total);
    w1 = __fdiv_rn(w1, total);
  } else {
    w0 = w1 = 0.0f;
  }
  if (!(f >= -0.5f && f <= static_cast<float>(size) - 0.5f)) w0 = w1 = 0.0f;
  t.w0 = w0;
  t.w1 = w1;
  return t;
}

// b / 255 rounded to nearest, for a byte b: the product with the rounded
// reciprocal 0x1.010102p-8, corrected once by its exact remainder. It equals
// __fdiv_rn(b, 255.0f) for every byte (scripts/torch_exact_division.py).
// b comes to float as the low bits of 2^23 + b, not through I2F,
// which runs at an eighth of the fp32 rate.
__device__ __forceinline__ float unit(uint32_t b) {
  const float f = __fsub_rn(__uint_as_float(0x4B000000u | b), 0x1p23f);
  const float r = 0x1.010102p-8f;
  const float q = __fmul_rn(f, r);
  return __fmaf_rn(__fmaf_rn(-q, 255.0f, f), r, q);
}

__device__ __forceinline__ float pick(int c, float a, float b, float d) {
  return c == 0 ? a : (c == 1 ? b : d);
}

// (v - m) / s with y = 1 / s (exact_div.cuh); the normalised crop's v - m
// lies in [-0.49, 0.6].
__device__ __forceinline__ float normalise(float v, float m, float s, float y) {
  return reid::std_quotient(__fsub_rn(v, m), s, y);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Lets the dependent launch (the erase fill) start; it still waits for this
// grid's completion (griddepcontrol.wait) before it reads or writes.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) & ~15; }

// Dynamic shared memory of a block: the column taps (a float4 a column), the
// row sums of `rows` staged rows, the band's row taps (a float4 a row), the
// staged bytes.
__host__ __device__ constexpr int smem_bytes(int w, int band_rows, int rows) {
  return 16 * w + round16(12 * w * rows) + 16 * band_rows + round16(3 * w * rows);
}

// Output rows [r0, r1) of a band and the source rows [lo, lo + rows) they read.
struct Chunk {
  int r0, r1, lo, rows;
};

// The next chunk from r0: as many rows (up to `chunk`) as `cap` staged rows
// serve. One output row reads two; an upsampling crop's chunk, chunk + 2.
__device__ __forceinline__ Chunk plan(const float4* yt, int r0, int y_lo, int y_hi, int chunk,
                                      int cap) {
  const float4 t = yt[r0 - y_lo];
  int lo = __float_as_int(t.x), hi = __float_as_int(t.y);
  int r1 = r0 + 1;
  for (; r1 < min(y_hi, r0 + chunk); ++r1) {
    const float4 u = yt[r1 - y_lo];
    const int a = min(lo, __float_as_int(u.x)), b = max(hi, __float_as_int(u.y));
    if (b - a >= cap) break;
    lo = a;
    hi = b;
  }
  return {r0, r1, lo, hi - lo + 1};
}

// Copies a chunk's source rows into shared memory: 16-byte cp.async copies
// (awaited by cp_async_wait_all) where the rows allow, else bytes.
__device__ __forceinline__ void stage(uint8_t* staged, const uint8_t* g, int nbytes, bool copy16,
                                      int tid) {
  if (copy16) {
    for (int i = 16 * tid; i < nbytes; i += 16 * kThreads) cp_async16(staged + i, g + i);
  } else {
    for (int i = tid; i < nbytes; i += kThreads) staged[i] = g[i];
  }
}

__global__ void __launch_bounds__(kThreads, 5)
train_augment_kernel(const uint8_t* __restrict__ src, const float* __restrict__ params,
                     float* __restrict__ dst, float* __restrict__ partial, int H, int W,
                     int band_rows, int chunk, int copy16, int vec, Norm nm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float scratch[3][kWarps];
  const int n = blockIdx.y, band = blockIdx.x;
  const int lane = threadIdx.x, warp = threadIdx.y, tid = warp * reid::kWarp + lane;
  const int W3 = 3 * W, cap = chunk + 2;        // row elements; staged rows a chunk
  float4* xt = reinterpret_cast<float4*>(smem);
  float* hsum = reinterpret_cast<float*>(smem + 16 * W);
  float4* yt = reinterpret_cast<float4*>(smem + 16 * W + round16(12 * W * cap));
  uint8_t* staged = smem + 16 * W + round16(12 * W * cap) + 16 * band_rows;

  const float* pr = params + n * kParams;
  const bool flip = pr[0] != 0.0f, erase = pr[5] != 0.0f;
  const float sy = __fdiv_rn(static_cast<float>(H), pr[3]);
  const float sx = __fdiv_rn(static_cast<float>(W), pr[4]);
  const float ty = __fmul_rn(-pr[1], sy), tx = __fmul_rn(-pr[2], sx);
  const float iy = __fdiv_rn(1.0f, sy), ix = __fdiv_rn(1.0f, sx);
  const int y_lo = band * band_rows, y_hi = min(H, y_lo + band_rows);
  const uint8_t* img = src + static_cast<size_t>(n) * H * W3;
  float* out = dst + static_cast<size_t>(n) * H * W3;
  // the rows an upsampling crop's first chunk reads start at the first row's
  // tap: they are on their way while the taps are made
  int first_lo = 0, first_rows = 0;
  if (y_lo < y_hi) {
    first_lo = clampi(taps(y_lo, iy, ty, H).i0, 0, H - 1);
    first_rows = min(cap, H - first_lo);
    stage(staged, img + static_cast<size_t>(first_lo) * W3, first_rows * W3, copy16, tid);
  }
  // the band's row taps: the two source rows (clamped; their weight is 0
  // where they fall outside) and the weights
  for (int r = tid; r < y_hi - y_lo; r += kThreads) {
    const Taps t = taps(y_lo + r, iy, ty, H);
    yt[r] = make_float4(__int_as_float(clampi(t.i0, 0, H - 1)),
                        __int_as_float(clampi(t.i0 + 1, 0, H - 1)), t.w0, t.w1);
  }
  __syncthreads();

  Chunk next = {y_lo, y_hi, 0, 0};
  if (y_lo < y_hi) {
    next = plan(yt, y_lo, y_lo, y_hi, chunk, cap);
    if (next.lo != first_lo || next.rows > first_rows) {  // a crop that does not upsample
      cp_async_wait_all();
      __syncthreads();
      stage(staged, img + static_cast<size_t>(next.lo) * W3, next.rows * W3, copy16, tid);
    }
  }
  // the column taps, with the flip folded into the source offsets, while the
  // first rows arrive
  for (int x = tid; x < W; x += kThreads) {
    const Taps t = taps(x, ix, tx, W);
    const int a = clampi(t.i0, 0, W - 1), b = clampi(t.i0 + 1, 0, W - 1);
    xt[x] = make_float4(__int_as_float(3 * (flip ? W - 1 - a : a)),
                        __int_as_float(3 * (flip ? W - 1 - b : b)), t.w0, t.w1);
  }
  cp_async_wait_all();
  __syncthreads();

  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  while (next.r0 < y_hi) {
    const Chunk cur = next;
    // horizontal pass, a warp a staged row, a lane a pixel: wx0 * t[s][x0] +
    // wx1 * t[s][x1] for each channel
    for (int s = warp; s < cur.rows; s += kWarps) {
#pragma unroll 4
      for (int x = lane; x < W; x += reid::kWarp) {
        const float4 t = xt[x];
        const uint8_t* pa = staged + s * W3 + __float_as_int(t.x);
        const uint8_t* pb = staged + s * W3 + __float_as_int(t.y);
        float* hp = hsum + s * W3 + 3 * x;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          hp[c] = __fadd_rn(__fmul_rn(t.z, unit(pa[c])), __fmul_rn(t.w, unit(pb[c])));
      }
    }
    __syncthreads();
    // the next chunk's rows arrive during the vertical pass
    if (cur.r1 < y_hi) {
      next = plan(yt, cur.r1, y_lo, y_hi, chunk, cap);
      stage(staged, img + static_cast<size_t>(next.lo) * W3, next.rows * W3, copy16, tid);
    } else {
      next.r0 = y_hi;
    }
    // vertical pass, normalise, store (the second launch overwrites the
    // erase rectangle)
    if (vec) {
      // a lane's float4s j = lane + 32 kk + 96 t all start at channel
      // m = j % 3 = (lane + 2 kk) % 3: their channels and the sums' are
      // rotations fixed for the loop
      const int q = W3 / 4;
#pragma unroll 1
      for (int kk = 0; kk < 3; ++kk) {
        const int m0 = (lane + 2 * kk) % 3, m1 = m0 == 2 ? 0 : m0 + 1, m2 = m0 == 0 ? 2 : m0 - 1;
        const float mu0 = pick(m0, nm.mean[0], nm.mean[1], nm.mean[2]);
        const float mu1 = pick(m1, nm.mean[0], nm.mean[1], nm.mean[2]);
        const float mu2 = pick(m2, nm.mean[0], nm.mean[1], nm.mean[2]);
        const float sd0 = pick(m0, nm.std[0], nm.std[1], nm.std[2]);
        const float sd1 = pick(m1, nm.std[0], nm.std[1], nm.std[2]);
        const float sd2 = pick(m2, nm.std[0], nm.std[1], nm.std[2]);
        const float iv0 = pick(m0, nm.inv[0], nm.inv[1], nm.inv[2]);
        const float iv1 = pick(m1, nm.inv[0], nm.inv[1], nm.inv[2]);
        const float iv2 = pick(m2, nm.inv[0], nm.inv[1], nm.inv[2]);
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;  // the sums of channels m0, m1, m2
        for (int j = lane + 32 * kk; j < q; j += 96) {
#pragma unroll 2
          for (int r = cur.r0 + warp; r < cur.r1; r += kWarps) {
            const float4 t = yt[r - y_lo];
            const float4 a = reinterpret_cast<const float4*>(
                hsum + (__float_as_int(t.x) - cur.lo) * W3)[j];
            const float4 b = reinterpret_cast<const float4*>(
                hsum + (__float_as_int(t.y) - cur.lo) * W3)[j];
            const float z0 = normalise(__fadd_rn(__fmul_rn(t.z, a.x), __fmul_rn(t.w, b.x)), mu0, sd0, iv0);
            const float z1 = normalise(__fadd_rn(__fmul_rn(t.z, a.y), __fmul_rn(t.w, b.y)), mu1, sd1, iv1);
            const float z2 = normalise(__fadd_rn(__fmul_rn(t.z, a.z), __fmul_rn(t.w, b.z)), mu2, sd2, iv2);
            const float z3 = normalise(__fadd_rn(__fmul_rn(t.z, a.w), __fmul_rn(t.w, b.w)), mu0, sd0, iv0);
            if (erase) {
              a0 += z0;
              a0 += z3;
              a1 += z1;
              a2 += z2;
            }
            __stcs(reinterpret_cast<float4*>(out + static_cast<size_t>(r) * W3) + j,
                   make_float4(z0, z1, z2, z3));
          }
        }
        acc0 += m0 == 0 ? a0 : (m0 == 2 ? a1 : a2);
        acc1 += m0 == 1 ? a0 : (m0 == 0 ? a1 : a2);
        acc2 += m0 == 2 ? a0 : (m0 == 1 ? a1 : a2);
      }
    } else {
      for (int r = cur.r0 + warp; r < cur.r1; r += kWarps) {
        const float4 t = yt[r - y_lo];
        const float* ha = hsum + (__float_as_int(t.x) - cur.lo) * W3;
        const float* hb = hsum + (__float_as_int(t.y) - cur.lo) * W3;
        float* orow = out + static_cast<size_t>(r) * W3;
        for (int e = lane; e < W3; e += reid::kWarp) {
          const int c = e % 3;
          const float z = normalise(__fadd_rn(__fmul_rn(t.z, ha[e]), __fmul_rn(t.w, hb[e])),
                                    pick(c, nm.mean[0], nm.mean[1], nm.mean[2]),
                                    pick(c, nm.std[0], nm.std[1], nm.std[2]),
                                    pick(c, nm.inv[0], nm.inv[1], nm.inv[2]));
          if (erase) {
            acc0 += c == 0 ? z : 0.0f;
            acc1 += c == 1 ? z : 0.0f;
            acc2 += c == 2 ? z : 0.0f;
          }
          __stcs(orow + e, z);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next chunk's rows are in, and no thread still reads these sums
  }
  if (!erase) {
    launch_dependents();
    return;
  }
  // the band's channel sums, in a fixed order: thread, warp, block
  acc0 = reid::warp_sum(acc0);
  acc1 = reid::warp_sum(acc1);
  acc2 = reid::warp_sum(acc2);
  if (lane == 0) {
    scratch[0][warp] = acc0;
    scratch[1][warp] = acc1;
    scratch[2][warp] = acc2;
  }
  __syncthreads();
  if (tid < 3) {
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s += scratch[tid][k];
    partial[(static_cast<size_t>(n) * kBands + band) * 3 + tid] = s;
  }
  launch_dependents();
}

// A block a band of an erased image: the fill is the image's band sums, added
// in band order, over H * W; it overwrites the band's part of the erase
// rectangle.
__global__ void __launch_bounds__(kThreads)
erase_fill_kernel(const float* __restrict__ params, const float* __restrict__ partial,
                  float* __restrict__ dst, int H, int W) {
  __shared__ float fill[3];
  const int n = blockIdx.y, band_rows = (H + kBands - 1) / kBands;
  const int y_lo = blockIdx.x * band_rows, y_hi = min(H, y_lo + band_rows);
  const float* pr = params + n * kParams;
  if (pr[5] == 0.0f) return;  // the whole block leaves together
  // the first launch's sums and stores are complete and visible past here
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int tid = threadIdx.y * reid::kWarp + threadIdx.x;
  if (tid < 3) {
    const float* part = partial + static_cast<size_t>(n) * kBands * 3;
    float s = 0.0f;
    for (int b = 0; b < kBands; ++b) s += part[b * 3 + tid];
    fill[tid] = s / static_cast<float>(H * W);
  }
  __syncthreads();
  const int top = max(0, static_cast<int>(pr[6])), bottom = min(H, static_cast<int>(pr[6] + pr[8]));
  const int e_left = 3 * max(0, static_cast<int>(pr[7]));
  const int e_right = 3 * min(W, static_cast<int>(pr[7] + pr[9]));
  float* out = dst + static_cast<size_t>(n) * H * W * 3;
  for (int r = max(top, y_lo) + threadIdx.y; r < min(bottom, y_hi); r += kWarps) {
    float* orow = out + static_cast<size_t>(r) * W * 3;
    for (int e = e_left + threadIdx.x; e < e_right; e += reid::kWarp) __stcs(orow + e, fill[e % 3]);
  }
}

}  // namespace

// The fp32 scratch that reid_train_augment needs: three channel sums per
// band.
extern "C" long long reid_train_augment_scratch(int n) {
  return static_cast<long long>(n) * kBands * 3;
}

// src: (N, H, W, 3) uint8 contiguous. params: (N, 10) fp32 on the device.
// dst: (N, H, W, 3) fp32 (the channels_last NCHW output). The output size
// equals the staged size. Refuses (cudaErrorInvalidValue) an empty batch,
// N > 65535 (the grid's y), an image past 2^31 elements, and a width whose
// three staged rows do not fit in a block's shared memory. With the ImageNet
// std values (the wrapper's) the normalisation is the IEEE quotient's bits.
extern "C" int reid_train_augment(const void* src, const void* params, void* dst,
                                  void* partial, int n, int h, int w, float m0, float m1,
                                  float m2, float s0, float s1, float s2, void* stream) {
  if (n < 1 || h < 1 || w < 1 || n > 65535 || 3LL * h * w > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int band_rows = (h + kBands - 1) / kBands;
  if (61LL * w > kSmemMax)  // a column's taps, 3 staged rows' sums and bytes: 16 + 36 + 9
    return static_cast<int>(cudaErrorInvalidValue);
  int chunk = std::min(band_rows, kChunkRows);
  while (chunk > 1 && smem_bytes(w, band_rows, chunk + 2) > kSmemDefault) --chunk;
  const int smem = smem_bytes(w, band_rows, chunk + 2);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t rc = cudaFuncSetAttribute(
        train_augment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int copy16 = (3 * w) % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const Norm nm = {{m0, m1, m2}, {s0, s1, s2}, {1.0f / s0, 1.0f / s1, 1.0f / s2}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  train_augment_kernel<<<dim3(kBands, n), dim3(reid::kWarp, kWarps), smem, st>>>(
      static_cast<const uint8_t*>(src), static_cast<const float*>(params),
      static_cast<float*>(dst), static_cast<float*>(partial), h, w, band_rows, chunk, copy16,
      vec, nm);
  const int rc = reid::launch_status();
  if (rc != 0) return rc;
  // a programmatic dependent launch: the second grid is launched while the
  // first one's last blocks run, and waits for it inside (griddepcontrol)
  cudaLaunchAttribute overlap;
  overlap.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBands, n);
  cfg.blockDim = dim3(reid::kWarp, kWarps);
  cfg.stream = st;
  cfg.attrs = &overlap;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, erase_fill_kernel,
                                           static_cast<const float*>(params),
                                           static_cast<const float*>(partial),
                                           static_cast<float*>(dst), h, w);
  if (e != cudaSuccess) return static_cast<int>(e);
  return reid::launch_status();
}
