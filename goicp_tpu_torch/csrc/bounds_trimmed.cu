// K5: screened fused TRIMMED bounds, one CTA per SE(3) node.
//
// Replaces the TPU kernel goicp_tpu/nn/mxu.py:_bounds_trimmed_kernel (called
// through _bounds_trimmed_padded from bounds_nodes_trimmed).  Per point, as in
// K2 (bounds.cu), ub term = (d + slack)², lb term l = max(max(d - slack, 0) -
// (af·|p| + γt), 0)²; a trimmed bound keeps only the h smallest terms.
//
// Screen: with l̃ = min(l, τ), any processed set S gives
//     trimmed_h(l) ≥ Σ_S l̃ - (N - h)·τ,
// so the kernel carries Σ l̃·valid over point blocks of tq = _pick_tile(Np,
// 384) (the TPU kernel's granularity, tested before each block, reduced in a
// fixed order) and skips the rest once it reaches thresh' = thresh + drop·τ
// (params slot 15).  A screened node reports ub = 1e30 and lb = Σl̃ - drop·τ.
// Survivors stage every term (pad lanes at 1e30) in a [2, Np] scratch and
// reduce it by the 24-step bisection (common.cuh: trimmed_bisect): the upper
// end for ub, the lower end for lb, as the TPU kernel does.
//
// What bounds it on an H100: the distance arithmetic of the blocks that run
// (as K2); the bisection adds 24 passes of one compare over 2·Np staged
// values per survivor.  Design: K2's CTA (blockDim = tq, targets through
// shared memory) plus the scratch in dynamic shared memory (8·Np bytes: 12 KB
// at Np = 1,536, 64 KB at the 8,192-point bound_points cap, with the opt-in).
// A source of more than ~27,000 points (bound_points raised that far) does
// not fit, and the launch fails with cudaErrorInvalidConfiguration.
// Screened nodes skip the bisection (the TPU kernel computes and discards
// it).

#include "common.cuh"

namespace goicp {

constexpr int kBtMaxThreads = 384;
constexpr int kBtTile = 512;

__global__ void __launch_bounds__(kBtMaxThreads)
bounds_trimmed_kernel(const float* __restrict__ params,  // [B, 24]
                      const float* __restrict__ srcT,    // [8, Np]
                      int Np,
                      const float* __restrict__ wm,      // [Mp, 8]
                      int Mp, int h, int drop,
                      float* __restrict__ ub_out,        // [B]
                      float* __restrict__ lb_out) {      // [B]
  extern __shared__ float scr[];                          // [2, Np]
  __shared__ float4 tile[kBtTile];
  __shared__ float fred[2 * kMaxWarps];
  __shared__ int ired[2 * kMaxWarps];
  const int b = blockIdx.x;
  const int tq = blockDim.x;
  const float* P = params + static_cast<size_t>(b) * 24;
  const float af = P[12], gt = P[13], slack = P[14];
  const float thresh_eff = P[15], tau = P[16];

  float acc = 0.f;
  for (int n0 = 0; n0 < Np; n0 += tq) {
    if (!(acc < thresh_eff)) break;  // uniform: every thread holds acc
    const int i = n0 + threadIdx.x;
    const float px = srcT[i], py = srcT[Np + i], pz = srcT[2 * Np + i];
    const float pn = srcT[3 * Np + i], pv = srcT[4 * Np + i];
    const float qx = fadd(dot3(px, py, pz, P[0], P[1], P[2]), P[9]);
    const float qy = fadd(dot3(px, py, pz, P[3], P[4], P[5]), P[10]);
    const float qz = fadd(dot3(px, py, pz, P[6], P[7], P[8]), P[11]);
    float d_hi, c;
    point_terms(min_dist2<kBtTile>(tile, wm, Mp, qx, qy, qz), slack, af, pn, gt,
                d_hi, c);
    const float lt = fmul(c, c);
    const float pad = fmul(fsub(1.f, pv), kPadSentinel);
    scr[i] = fadd(fmul(fmul(d_hi, d_hi), pv), pad);
    scr[Np + i] = fadd(fmul(lt, pv), pad);
    float s[1] = {fmul(fminf(lt, tau), pv)};
    block_reduce<SumF>(s, fred);  // its __syncthreads also publishes scr
    acc = fadd(acc, s[0]);
  }
  if (acc >= thresh_eff) {
    if (threadIdx.x == 0) {
      ub_out[b] = kPadSentinel;
      lb_out[b] = fsub(acc, fmul(static_cast<float>(drop), tau));
    }
    return;
  }
  float up[2], down[2];
  trimmed_bisect<2>(scr, Np, h, fred, ired, up, down);
  if (threadIdx.x == 0) {
    ub_out[b] = up[0];    // upper end for the upper bound
    lb_out[b] = down[1];  // lower end for the lower bound
  }
}

}  // namespace goicp

extern "C" int goicp_bounds_nodes_trimmed(const float* params, int B,
                                          const float* srcT, int Np,
                                          const float* wm, int Mp, int tq,
                                          int h, int drop, float* ub,
                                          float* lb, void* stream) {
  const size_t dyn = static_cast<size_t>(2) * Np * sizeof(float);
  if (!goicp::smem_fits(goicp::bounds_trimmed_kernel, dyn))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  goicp::bounds_trimmed_kernel<<<B, tq, dyn, static_cast<cudaStream_t>(stream)>>>(
      params, srcT, Np, wm, Mp, h, drop, ub, lb);
  return static_cast<int>(cudaGetLastError());
}
