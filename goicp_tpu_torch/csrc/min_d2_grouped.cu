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
// + a_j, then clamped at 0.  It rounds differently from the direct
// |u + t_j - m|², and the bounds must match the reference, so the direct
// form is not used.  Output row 8g + j, column = point.
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
constexpr int kGrTile = 256;

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
#pragma unroll
  for (int j = 0; j < 8; ++j) best[j] = __int_as_float(0x7f800000);

  for (int m0 = 0; m0 < Mp; m0 += kGrTile) {
    const int n = min(kGrTile, Mp - m0);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const float* w = wm + static_cast<size_t>(m0 + k) * 8;
      const float wx = w[0], wy = w[1], wz = w[2];
      tw[k] = make_float4(wx, wy, wz, 0.f);
      float b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s = dot3(gp[9 + 3 * j], gp[10 + 3 * j], gp[11 + 3 * j],
                             wx, wy, wz);
        b[j] = fsub(gp[33 + j], fmul(2.f, s));
      }
      tb[k][0] = make_float4(b[0], b[1], b[2], b[3]);
      tb[k][1] = make_float4(b[4], b[5], b[6], b[7]);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float G = dist2(tw[k], ux, uy, uz);
      const float4 b0 = tb[k][0], b1 = tb[k][1];
      best[0] = fminf(best[0], fadd(G, b0.x));
      best[1] = fminf(best[1], fadd(G, b0.y));
      best[2] = fminf(best[2], fadd(G, b0.z));
      best[3] = fminf(best[3], fadd(G, b0.w));
      best[4] = fminf(best[4], fadd(G, b1.x));
      best[5] = fminf(best[5], fadd(G, b1.y));
      best[6] = fminf(best[6], fadd(G, b1.z));
      best[7] = fminf(best[7], fadd(G, b1.w));
    }
  }
  if (i < Np) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = fmul(2.f, dot3(gp[9 + 3 * j], gp[10 + 3 * j],
                                     gp[11 + 3 * j], ux, uy, uz));
      d2[(static_cast<size_t>(g) * 8 + j) * Np + i] = fmaxf(fadd(best[j], a), 0.f);
    }
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
