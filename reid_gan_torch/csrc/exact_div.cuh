// Divisions by the ImageNet std values as products: the piece that K4
// (train_augment.cu) and K12 (diff_transform.cu) share.
#pragma once

namespace reid {

// The quotient a / s without a division: the product with y = 1 / s rounded
// to nearest, corrected once by its exact remainder a - s q (Markstein's
// step, fma). For the ImageNet std values this equals __fdiv_rn(a, s) for
// every float a with 2^-40 <= |a| <= 1 and a = 0, checked exhaustively
// (scripts/torch_exact_division.py); a = v - mean of two floats is 0 or at
// least 2^-27 in magnitude. Three fp32 instructions where __fdiv_rn takes
// about ten, one of them a quarter-rate MUFU.RCP.
__device__ __forceinline__ float std_quotient(float a, float s, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-s, q, a), y, q);
}

}  // namespace reid
