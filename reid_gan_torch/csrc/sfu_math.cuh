// log2 and 2^x on the special-function unit: the pieces that K2
// (gem_bn_l2n.cu) and K5 (gem_pool.cu) share. GeM takes xc^p as
// 2^(p log2 xc), one lg2 and one ex2 an element (about 2 ulp each; the
// inputs are >= eps, so normal), where an accurate powf costs a long chain
// of instructions.
#pragma once

namespace reid {

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace reid
