// K7: screened fused bounds for 8 translation siblings per rotation, one CTA
// per group.
//
// Replaces the TPU kernel goicp_tpu/nn/mxu.py:_bounds_grouped_kernel (called
// through _bounds_grouped_padded from bounds_groups): K3's separable
// distances (common.cuh: grouped_min, grouped_d2) with K2's epilogue per
// sibling, ub_j += (d + slack)²·valid and lb_j += max(max(d - slack, 0) -
// (af·|p| + γt_j), 0)²·valid, summed over point blocks of tq =
// _pick_tile(Np, 384).  The group skips the remaining blocks once the
// smallest carried lb reaches thresh (slot 51), and then reports ub = 1e30
// for all 8 siblings.  Parameter row [64]: R×9, t8×24, |t_j|²×8, af (41),
// γt×8 (42-49), slack (50), thresh (51).  No solver path of either package
// calls it (untrimmed T-rounds stay on K3, goicp_tpu/bnb/se3_eval.py:436);
// it completes the port's set of kernels.
//
// What bounds it on an H100: the grouped distance arithmetic on the blocks
// that run (24 operations per (point, target) pair for 8 siblings).  Design:
// blockDim = tq, one thread per point of the block; 16 sums per block reduce
// in one fixed-order block_reduce, so the skip test is uniform.

#include "common.cuh"

namespace goicp {

constexpr int kBgMaxThreads = 384;

__global__ void __launch_bounds__(kBgMaxThreads)
bounds_grouped_kernel(const float* __restrict__ gparams,  // [G, 64]
                      const float* __restrict__ srcT,     // [8, Np]
                      int Np,
                      const float* __restrict__ wm,       // [Mp, 8]
                      int Mp,
                      float* __restrict__ ub_out,         // [8G]
                      float* __restrict__ lb_out) {       // [8G]
  __shared__ float4 tw[kGrTile];
  __shared__ float4 tb[kGrTile][2];
  __shared__ float gp[64];
  __shared__ float red[16 * kMaxWarps];
  const int g = blockIdx.x;
  const int tq = blockDim.x;
  if (threadIdx.x < 64) gp[threadIdx.x] = gparams[static_cast<size_t>(g) * 64 + threadIdx.x];
  __syncthreads();
  const float af = gp[41], slack = gp[50], thresh = gp[51];

  float acc[16];  // ub_0..ub_7, lb_0..lb_7
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.f;
  float lmin = 0.f;
  for (int n0 = 0; n0 < Np; n0 += tq) {
    if (!(lmin < thresh)) break;  // uniform: every thread holds acc
    const int i = n0 + threadIdx.x;
    const float px = srcT[i], py = srcT[Np + i], pz = srcT[2 * Np + i];
    const float pn = srcT[3 * Np + i], pv = srcT[4 * Np + i];
    const float ux = dot3(px, py, pz, gp[0], gp[1], gp[2]);
    const float uy = dot3(px, py, pz, gp[3], gp[4], gp[5]);
    const float uz = dot3(px, py, pz, gp[6], gp[7], gp[8]);
    float best[8];
    grouped_min(best, tw, tb, gp, wm, Mp, ux, uy, uz);
    float s[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float d_hi, c;
      point_terms(grouped_d2(gp, j, best[j], ux, uy, uz), slack, af, pn,
                  gp[42 + j], d_hi, c);
      s[j] = fmul(fmul(d_hi, d_hi), pv);
      s[8 + j] = fmul(fmul(c, c), pv);
    }
    block_reduce<SumF>(s, red);
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = fadd(acc[k], s[k]);
    lmin = acc[8];
#pragma unroll
    for (int j = 1; j < 8; ++j) lmin = fminf(lmin, acc[8 + j]);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ub_out[static_cast<size_t>(g) * 8 + j] = lmin < thresh ? acc[j] : kPadSentinel;
      lb_out[static_cast<size_t>(g) * 8 + j] = acc[8 + j];
    }
  }
}

}  // namespace goicp

extern "C" int goicp_bounds_groups(const float* gparams, int G, const float* srcT,
                                   int Np, const float* wm, int Mp, int tq,
                                   float* ub, float* lb, void* stream) {
  goicp::bounds_grouped_kernel<<<G, tq, 0, static_cast<cudaStream_t>(stream)>>>(
      gparams, srcT, Np, wm, Mp, ub, lb);
  return static_cast<int>(cudaGetLastError());
}
