// Shared helpers of the goicp_tpu_torch Hopper kernels.
//
// Every product and sum below is written with the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts
// into FMAs.  The kernels then round exactly as the plain PyTorch versions
// in nn/fused.py do (one rounding per operation), so a kernel and its plain
// version agree bit for bit on every per-point distance and the same
// nearest target wins.  The cost is two extra instructions per pair
// (9 instead of 7 with FMA contraction), a trade recorded in PERF.md.

#pragma once

#include <cuda_runtime.h>

namespace goicp {

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

// ((x*r0 + y*r1) + z*r2): one row of R·p, in the JAX kernels' order.
__device__ __forceinline__ float dot3(float x, float y, float z,
                                      float r0, float r1, float r2) {
  return fadd(fadd(fmul(x, r0), fmul(y, r1)), fmul(z, r2));
}

// |w - q|² in the "diff" form of nn/mxu.py: ((dx² + dy²) + dz²).
__device__ __forceinline__ float dist2(float4 w, float qx, float qy, float qz) {
  float dx = fsub(w.x, qx), dy = fsub(w.y, qy), dz = fsub(w.z, qz);
  return fadd(fadd(fmul(dx, dx), fmul(dy, dy)), fmul(dz, dz));
}

// Copy targets [m0, m0+n) of wm [Mp, 8] (cols m_x, m_y, m_z, ...) into
// shared memory as float4 (x, y, z, 0), one target per thread per pass.
__device__ __forceinline__ void stage_targets(float4* tile, const float* wm,
                                              int m0, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* w = wm + static_cast<size_t>(m0 + k) * 8;
    tile[k] = make_float4(w[0], w[1], w[2], 0.f);
  }
}

}  // namespace goicp
