// K3: grouped min distances for 8 translation siblings sharing a rotation.
//
// Replaces the TPU kernel goicp_tpu/nn/mxu.py:_min_d2_grouped_kernel (called
// through _min_d2_grouped_padded from min_d2_groups) in both of its forms.
// For a group g with rotation R_g and sibling translations t_j (j < 8), and
// u = R_g·p, the separable form
//
//     |u + t_j - m|² = G[m] + b_j[m] + a_j,   G[m] = |u - m|²,
//     b_j[m] = |t_j|² - 2 t_j·m,              a_j = 2 t_j·u,
//
// is evaluated exactly as the TPU kernel does: min over m of (G + b_j), then
// + a_j, then clamped at 0 (common.cuh: grouped_min, grouped_d2).  It rounds
// differently from the direct |u + t_j - m|², and the bounds must match the
// reference, so the direct form is not used.  The "exp" form (variant=
// "exp", on no solver path) takes the base plane |m|² - 2u·m in three FMAs
// and adds |u|² with a_j after the min (grouped_d2_exp); its products are
// contracted as XLA's CPU build contracts them, like its plain version.
// Output row 8g + j, column = point.
//
// What bounds it on an H100: arithmetic.  Per (point, target) pair the base
// plane G costs 8 operations once for the group ("exp": 3 FMAs) and each
// sibling 2 (add, min): 24 per pair ("exp": 19), 3 per node-pair.  The
// output write ([8G, Np] f32, up to 129 MB per T-round) is ~100x below the
// arithmetic time.  Design: one block per (group, 128-point tile); each
// thread holds its point's 8 running minima in registers.  The block stages
// 256 targets at a time into shared memory together with b_j[m] for all 8
// siblings, so b_j is computed once per (group, target) per block instead of
// once per pair.

#include "common.cuh"

namespace goicp {

constexpr int kGrThreads = 128;

template <int FORM>
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
  float best[8];
  if (FORM == kExp) {
    const float ux = dot3c(px, py, pz, gp[0], gp[1], gp[2]);
    const float uy = dot3c(px, py, pz, gp[3], gp[4], gp[5]);
    const float uz = dot3c(px, py, pz, gp[6], gp[7], gp[8]);
    const float un = dot3c(ux, uy, uz, ux, uy, uz);
    grouped_min<kExp>(best, tw, tb, gp, wm, Mp, fmul(-2.f, ux), fmul(-2.f, uy), fmul(-2.f, uz));
    if (i < Np) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d2[(static_cast<size_t>(g) * 8 + j) * Np + i] =
            grouped_d2_exp(gp, j, best[j], ux, uy, uz, un);
    }
  } else {
    const float ux = dot3(px, py, pz, gp[0], gp[1], gp[2]);
    const float uy = dot3(px, py, pz, gp[3], gp[4], gp[5]);
    const float uz = dot3(px, py, pz, gp[6], gp[7], gp[8]);
    grouped_min(best, tw, tb, gp, wm, Mp, ux, uy, uz);
    if (i < Np) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d2[(static_cast<size_t>(g) * 8 + j) * Np + i] = grouped_d2(gp, j, best[j], ux, uy, uz);
    }
  }
}

}  // namespace goicp

// K3: d2 [8G, Np] in the form `form` (kDiff or kExp).
extern "C" int goicp_min_d2_grouped(const float* gparams, int G,
                                    const float* srcT, int Np, const float* wm,
                                    int Mp, int form, float* d2, void* stream) {
  using namespace goicp;
  dim3 grid((Np + kGrThreads - 1) / kGrThreads, G);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kDiff:
      min_d2_grouped_kernel<kDiff><<<grid, kGrThreads, 0, st>>>(gparams, srcT, Np, wm, Mp, d2);
      break;
    case kExp:
      min_d2_grouped_kernel<kExp><<<grid, kGrThreads, 0, st>>>(gparams, srcT, Np, wm, Mp, d2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
