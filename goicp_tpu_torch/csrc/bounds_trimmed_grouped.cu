// K6: screened fused TRIMMED bounds for 8 translation siblings per rotation,
// one CTA per group.
//
// Replaces the TPU kernel goicp_tpu/nn/mxu.py:_bounds_trimmed_grouped_kernel
// (called through _bounds_trimmed_grouped_padded from bounds_groups_trimmed):
// the grouped twin of K5 (bounds_trimmed.cu).
//   - The distances come in K3's separable form (common.cuh: grouped_min,
//     grouped_d2): the base plane |u - m|² once per group and target, each
//     sibling 2 operations per pair.
//   - Each sibling carries its own clamped sum Σ min(l, τ)·valid over point
//     blocks of tq = _pick_tile(Np, 384); the next block is skipped once
//     EVERY sibling's sum reaches thresh' (slot 51), as the TPU kernel does.
//     A screened group reports ub = 1e30 and lb = Σl̃ - drop·τ per sibling.
//   - Survivors stage all 16 rows of terms (8 ub rows, 8 lb rows, pad lanes
//     at 1e30) and run the 24-step bisection on all 16 at once.
// Parameter row [64]: R×9, t8×24, |t_j|²×8, af (41), γt×8 (42-49), slack
// (50), thresh' (51), τ (52).
//
// What bounds it on an H100: the grouped distance arithmetic (K3's 24
// operations per (point, target) pair for 8 siblings) on the blocks that
// run, plus 24 bisection passes over 16·Np staged values per survivor.  The
// [16, Np] scratch is 64·Np bytes: 96 KB at Np = 1,536 fits in shared memory
// with the opt-in (two CTAs per SM); from Np ≈ 3,300 on it no longer fits in
// a block, and the wrapper passes a global [G, 16, Np] buffer instead (the
// same code through generic addressing).  Screened groups skip the
// bisection.

#include "common.cuh"

namespace goicp {

constexpr int kGtMaxThreads = 384;

__global__ void __launch_bounds__(kGtMaxThreads)
bounds_trimmed_grouped_kernel(const float* __restrict__ gparams,  // [G, 64]
                              const float* __restrict__ srcT,     // [8, Np]
                              int Np,
                              const float* __restrict__ wm,       // [Mp, 8]
                              int Mp, int h, int drop,
                              float* __restrict__ gscr,   // [G, 16, Np] or null
                              float* __restrict__ ub_out,         // [8G]
                              float* __restrict__ lb_out) {       // [8G]
  extern __shared__ float dyn[];
  __shared__ float4 tw[kGrTile];
  __shared__ float4 tb[kGrTile][2];
  __shared__ float gp[64];
  __shared__ float fred[16 * kMaxWarps];
  __shared__ int ired[16 * kMaxWarps];
  const int g = blockIdx.x;
  const int tq = blockDim.x;
  float* scr = gscr == nullptr ? dyn : gscr + static_cast<size_t>(g) * 16 * Np;
  if (threadIdx.x < 64) gp[threadIdx.x] = gparams[static_cast<size_t>(g) * 64 + threadIdx.x];
  __syncthreads();
  const float af = gp[41], slack = gp[50], thresh_eff = gp[51], tau = gp[52];

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int n0 = 0; n0 < Np; n0 += tq) {
    float amin = acc[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) amin = fminf(amin, acc[j]);
    if (!(amin < thresh_eff)) break;  // uniform: every thread holds acc
    const int i = n0 + threadIdx.x;
    const float px = srcT[i], py = srcT[Np + i], pz = srcT[2 * Np + i];
    const float pn = srcT[3 * Np + i], pv = srcT[4 * Np + i];
    const float ux = dot3(px, py, pz, gp[0], gp[1], gp[2]);
    const float uy = dot3(px, py, pz, gp[3], gp[4], gp[5]);
    const float uz = dot3(px, py, pz, gp[6], gp[7], gp[8]);
    float best[8];
    grouped_min(best, tw, tb, gp, wm, Mp, ux, uy, uz);
    const float pad = fmul(fsub(1.f, pv), kPadSentinel);
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float d_hi, c;
      point_terms(grouped_d2(gp, j, best[j], ux, uy, uz), slack, af, pn,
                  gp[42 + j], d_hi, c);
      const float lt = fmul(c, c);
      scr[static_cast<size_t>(j) * Np + i] = fadd(fmul(fmul(d_hi, d_hi), pv), pad);
      scr[static_cast<size_t>(8 + j) * Np + i] = fadd(fmul(lt, pv), pad);
      s[j] = fmul(fminf(lt, tau), pv);
    }
    block_reduce<SumF>(s, fred);  // its __syncthreads also publishes scr
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fadd(acc[j], s[j]);
  }
  float amin = acc[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) amin = fminf(amin, acc[j]);
  if (amin >= thresh_eff) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ub_out[static_cast<size_t>(g) * 8 + j] = kPadSentinel;
        lb_out[static_cast<size_t>(g) * 8 + j] = fsub(acc[j], fmul(static_cast<float>(drop), tau));
      }
    }
    return;
  }
  float up[16], down[16];
  trimmed_bisect<16>(scr, Np, h, fred, ired, up, down);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ub_out[static_cast<size_t>(g) * 8 + j] = up[j];        // ub rows: upper end
      lb_out[static_cast<size_t>(g) * 8 + j] = down[8 + j];  // lb rows: lower end
    }
  }
}

}  // namespace goicp

// 1 when the [16, Np] scratch fits in shared memory, else 0 (the caller then
// passes a global buffer).
extern "C" int goicp_bounds_groups_trimmed_smem(int Np) {
  return goicp::smem_fits(goicp::bounds_trimmed_grouped_kernel,
                          static_cast<size_t>(16) * Np * sizeof(float));
}

extern "C" int goicp_bounds_groups_trimmed(const float* gparams, int G,
                                           const float* srcT, int Np,
                                           const float* wm, int Mp, int tq,
                                           int h, int drop, float* gscr,
                                           float* ub, float* lb, void* stream) {
  const size_t dyn = gscr == nullptr ? static_cast<size_t>(16) * Np * sizeof(float) : 0;
  if (dyn && !goicp::smem_fits(goicp::bounds_trimmed_grouped_kernel, dyn))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  goicp::bounds_trimmed_grouped_kernel<<<G, tq, dyn,
                                         static_cast<cudaStream_t>(stream)>>>(
      gparams, srcT, Np, wm, Mp, h, drop, gscr, ub, lb);
  return static_cast<int>(cudaGetLastError());
}
