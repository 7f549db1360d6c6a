// K3: grouped min distances for 8 translation siblings sharing a rotation.
//
// Replaces the TPU kernel goicp_tpu/nn/mxu.py:_min_d2_grouped_kernel (called
// through _min_d2_grouped_padded from min_d2_groups, "diff" form).  For a
// group g with rotation R_g and sibling translations t_j (j < 8), and
// u = R_g·p, the separable form
//
//     |u + t_j - m|² = G[m] + b_j[m] + a_j,   G[m] = |u - m|²,
//     b_j[m] = |t_j|² - 2 t_j·m,              a_j = 2 t_j·u,
//
// is evaluated exactly as the TPU kernel does: min over m of (G + b_j), then
// + a_j, then clamped at 0 (common.cuh: grouped_min, grouped_d2).  It rounds
// differently from the direct |u + t_j - m|², and the bounds must match the
// reference, so the direct form is not used.  Output row 8g + j, column =
// point.
//
// What bounds it on an H100: arithmetic.  Per (point, target) pair the base
// plane G costs 8 operations once for the group and each sibling 2 (add,
// min): 24 per pair, 3 per node-pair.  The output write ([8G, Np] f32, up to
// 129 MB per T-round) is ~100x below the arithmetic time.  Design: one block
// per (group, 128-point tile); each thread holds its point's 8 running
// minima in registers.  The block stages 256 targets at a time into shared
// memory together with b_j[m] for all 8 siblings, so b_j is computed once
// per (group, target) per block instead of once per pair.

#include "common.cuh"

namespace goicp {

constexpr int kGrThreads = 128;

__global__ void __launch_bounds__(kGrThreads)
min_d2_grouped_kernel(const float* __restrict__ gparams,  // [G, 48]
                      const float* __restrict__ srcT,     // [8, Np]
                      int Np,
                      const float* __restrict__ wm,       // [Mp, 8]
                      int Mp,
                      float* __restrict__ d2) {           // [8G, Np]
  __shared__ float4 tw[kGrTile];
  __shared__ float4 tb[kGrTile][2];  // b_0..b_3, b_4..b_7 per target
  __shared__ float gp[48];
  const int g = blockIdx.y;
  if (threadIdx.x < 48) gp[threadIdx.x] = gparams[static_cast<size_t>(g) * 48 + threadIdx.x];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (i < Np) {
    px = srcT[i];
    py = srcT[Np + i];
    pz = srcT[2 * Np + i];
  }
  const float ux = dot3(px, py, pz, gp[0], gp[1], gp[2]);
  const float uy = dot3(px, py, pz, gp[3], gp[4], gp[5]);
  const float uz = dot3(px, py, pz, gp[6], gp[7], gp[8]);

  float best[8];
  grouped_min(best, tw, tb, gp, wm, Mp, ux, uy, uz);
  if (i < Np) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      d2[(static_cast<size_t>(g) * 8 + j) * Np + i] = grouped_d2(gp, j, best[j], ux, uy, uz);
  }
}

}  // namespace goicp

extern "C" int goicp_min_d2_grouped(const float* gparams, int G,
                                    const float* srcT, int Np, const float* wm,
                                    int Mp, float* d2, void* stream) {
  dim3 grid((Np + goicp::kGrThreads - 1) / goicp::kGrThreads, G);
  goicp::min_d2_grouped_kernel<<<grid, goicp::kGrThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      gparams, srcT, Np, wm, Mp, d2);
  return static_cast<int>(cudaGetLastError());
}
