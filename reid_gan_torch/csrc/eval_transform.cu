// K1: fused eval transform, uint8 NHWC staging batch -> normalised NCHW batch
// in channels_last memory (physically NHWC), as fp32 or bf16.
//
// Replaces: reid_gan_tpu/ops/transforms.py::reid_augment(train=False)
// (ops/transforms.py:137-151: to_float -> resize no-op -> normalize), as fused
// into the extractor's jitted forward with the cast to the extractor dtype
// (engine/evaluators.py:44-47).
//
// Arithmetic follows the JAX order exactly: x/255, then -mean, then /std,
// with IEEE divisions (no reciprocal multiply), then round-to-nearest-even
// to bf16 when asked.
//
// Bound: bytes. Per element it reads 1 byte and writes 2 (bf16) or 4 (fp32);
// at batch 256 of 256x128 that is 25.2 MB read + 50.3 MB written (bf16),
// 22.5 us at 3.35 TB/s, or + 100.7 MB (fp32), 37.6 us. Channels_last output
// makes the map a pure elementwise pass over the input's own order (channel
// = flat index mod 3), so reads and writes are both contiguous. The design
// keeps the instructions per byte few and every access coalesced:
// - The value depends only on (channel, byte). Each block builds the
//   768-entry table of (b / 255 - mean[c]) / std[c] in shared memory, in the
//   same IEEE order; for bf16 the entries are stored already rounded
//   (__float2bfloat16_rn), so the bits are those of rounding each value. No
//   division is left per element.
// - A chunk is 4 input bytes, one 32-bit load, and its 4 outputs, one
//   16-byte (fp32) or 8-byte (bf16) store. A warp takes 32 x kUnroll
//   consecutive chunks, a lane every 32nd, so each load and each store
//   instruction of the warp covers one contiguous run (128 bytes in, 512 or
//   256 out), streaming (st.global.cs: 3% faster than plain stores, as
//   50-100 MB does not stay in L2), and a lane keeps kUnroll loads in
//   flight. A chunk's first channel is its index mod 3: one 64-bit modulo
//   a lane and step, then a compile-time offset a chunk; no modulo per
//   element.
// - A 4-byte aligned batch is all it needs; the last block writes the tail
//   past the last whole chunk (under 4 values) one value a thread.
// `scripts/torch_transform_probe.py` times the alternatives: 16-byte loads
// (a lane's outputs then lie 64 bytes apart: 35% slower in bf16), the
// 48-byte groups of three 16-byte loads a thread (2.3x slower in bf16, 4.3x
// in fp32), plain stores and other unrolls.
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / reid::kWarp;
constexpr int kVec = 4;            // bytes a chunk: one load
constexpr int kUnroll = 8;         // chunks a lane takes a step
constexpr int kLaneStep = 1;       // chunks between a lane's first and the next lane's
constexpr int kChunkStep = 32;     // chunks between a lane's consecutive ones
constexpr bool kStream = true;     // st.global.cs: the output does not stay in L2

struct Norm {
  float mean[3], std[3];
};

// The table's entry for an output type: the fp32 value, or its bf16 bits.
template <typename T>
struct Entry;
template <>
struct Entry<float> {
  using type = float;
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <>
struct Entry<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ unsigned short from(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// One load of kBytes.
template <int kBytes>
struct Chunk;
template <>
struct Chunk<16> {
  using type = uint4;
};
template <>
struct Chunk<8> {
  using type = uint2;
};
template <>
struct Chunk<4> {
  using type = unsigned int;
};

__device__ __forceinline__ unsigned int word(const uint4& w, int i) {
  return i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
}
__device__ __forceinline__ unsigned int word(const uint2& w, int i) { return i == 0 ? w.x : w.y; }
__device__ __forceinline__ unsigned int word(unsigned int w, int) { return w; }

// byte q of w, zero-extended
__device__ __forceinline__ unsigned int byte_of(unsigned int w, int q) {
  return __byte_perm(w, 0u, 0x4440u | q);
}

template <typename V>
__device__ __forceinline__ void put(V* p, const V& v) {
  if (kStream) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// The kVec values of chunk w to o; off[k] is the table's offset of the
// channel of the chunk's bytes k, k + 3, ...
__device__ __forceinline__ void emit(float* o, const Chunk<kVec>::type& w, const float* table,
                                     const int (&off)[3]) {
  float v[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = table[off[j % 3] + byte_of(word(w, j / 4), j % 4)];
#pragma unroll
  for (int i = 0; i < kVec / 4; ++i)
    put(reinterpret_cast<float4*>(o) + i, make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]));
}

__device__ __forceinline__ void emit(__nv_bfloat16* o, const Chunk<kVec>::type& w,
                                     const unsigned short* table, const int (&off)[3]) {
  unsigned int p[kVec / 2];
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const int j = 2 * i;
    const unsigned int lo = table[off[j % 3] + byte_of(word(w, j / 4), j % 4)];
    const unsigned int hi = table[off[(j + 1) % 3] + byte_of(word(w, j / 4), j % 4 + 1)];
    p[i] = __byte_perm(lo, hi, 0x5410);
  }
  if constexpr (kVec == 4) {
    put(reinterpret_cast<uint2*>(o), make_uint2(p[0], p[1]));
  } else {
#pragma unroll
    for (int i = 0; i < kVec / 8; ++i)
      put(reinterpret_cast<uint4*>(o) + i, make_uint4(p[4 * i], p[4 * i + 1], p[4 * i + 2], p[4 * i + 3]));
  }
}

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, unsigned short v) {
  *reinterpret_cast<unsigned short*>(dst) = v;
}

// `chunks` whole chunks of kVec bytes, then the tail up to n.
template <typename T>
__global__ void __launch_bounds__(kThreads)
eval_transform_kernel(const uint8_t* __restrict__ src, T* __restrict__ dst, long long chunks,
                      long long n, Norm nm) {
  using E = typename Entry<T>::type;
  using C = Chunk<kVec>::type;
  __shared__ E table[3 * 256];
  for (int i = threadIdx.x; i < 3 * 256; i += kThreads) {
    const int c = i >> 8;
    table[i] = Entry<T>::from(__fdiv_rn(
        __fsub_rn(__fdiv_rn(static_cast<float>(i & 255), 255.0f), nm.mean[c]), nm.std[c]));
  }
  __syncthreads();
  const C* in = reinterpret_cast<const C*>(src);
  const int lane = threadIdx.x % reid::kWarp;
  constexpr long long kSpan = static_cast<long long>(reid::kWarp) * kUnroll;   // chunks a warp step
  const long long step = static_cast<long long>(gridDim.x) * kWarps * kSpan;
  for (long long first = (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / reid::kWarp) * kSpan;
       first < chunks; first += step) {
    const long long at = first + kLaneStep * lane;     // this lane's first chunk
    const int ph = static_cast<int>((at * kVec) % 3);  // the channel of its first byte
    C w[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long ci = at + kChunkStep * j;
      w[j] = ci < chunks ? __ldg(in + ci) : C{};
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long ci = at + kChunkStep * j;
      if (ci < chunks) {
        const int c0 = (ph + (kChunkStep * j * kVec) % 3) % 3;
        const int off[3] = {c0 * 256, (c0 + 1) % 3 * 256, (c0 + 2) % 3 * 256};
        emit(dst + ci * kVec, w[j], table, off);
      }
    }
  }
  if (blockIdx.x == gridDim.x - 1) {
    for (long long e = chunks * kVec + threadIdx.x; e < n; e += kThreads)
      store1(dst + e, table[static_cast<int>(e % 3) * 256 + src[e]]);
  }
}

template <typename T>
int launch(const uint8_t* src, T* dst, long long n, const Norm& nm, cudaStream_t stream) {
  const long long chunks = n / kVec;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eval_transform_kernel<T>, kThreads, 0);
  const long long per_block = static_cast<long long>(kWarps) * reid::kWarp * kUnroll;
  const long long want = std::max(1LL, (chunks + per_block - 1) / per_block);
  const int grid = static_cast<int>(std::min(want, std::max(1LL, static_cast<long long>(sms) * per_sm)));
  eval_transform_kernel<T><<<grid, kThreads, 0, stream>>>(src, dst, chunks, n, nm);
  return reid::launch_status();
}

}  // namespace

// src: n uint8 values, (N, H, W, 3) contiguous, kVec-byte aligned (4).
// dst: n values, 16-byte aligned; out_bf16 selects bf16 over fp32. Refuses
// (cudaErrorInvalidValue) a negative n and a misaligned pointer.
extern "C" int reid_eval_transform(const void* src, void* dst, long long n,
                                   int out_bf16, float m0, float m1, float m2,
                                   float s0, float s1, float s2,
                                   void* stream) {
  if (n < 0 || reinterpret_cast<uintptr_t>(src) % kVec || reinterpret_cast<uintptr_t>(dst) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Norm nm = {{m0, m1, m2}, {s0, s1, s2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  if (out_bf16) return launch(in, static_cast<__nv_bfloat16*>(dst), n, nm, s);
  return launch(in, static_cast<float*>(dst), n, nm, s);
}
