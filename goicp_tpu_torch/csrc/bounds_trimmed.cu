// K5: screened fused TRIMMED bounds of SE(3) nodes, one warp per node.
//
// Replaces the TPU kernel goicp_tpu/nn/mxu.py:_bounds_trimmed_kernel (called
// through _bounds_trimmed_padded from bounds_nodes_trimmed).  Per point, as in
// K2 (bounds.cu), ub term = (d + slack)², lb term l = max(max(d - slack, 0) -
// (af·|p| + γt), 0)²; a trimmed bound keeps only the h smallest terms.
//
// Screen: with l̃ = min(l, τ), any processed set S gives
//     trimmed_h(l) ≥ Σ_S l̃ - (N - h)·τ,
// so the kernel carries Σ l̃·valid over point blocks of tq = _pick_tile(Np,
// 384) (the TPU kernel's granularity, tested before each block, in point
// order) and skips the rest once it reaches thresh' = thresh + drop·τ
// (params slot 15).  A screened node reports ub = 1e30 and lb = Σl̃ - drop·τ
// and skips the bisection; a masked node (thresh' = -inf) stops before its
// first block.  Survivors stage every term (pad lanes at 1e30) in a [2, Np]
// scratch and reduce each row by the 24-step bisection (common.cuh:
// warp_trimmed_bisect): the upper end for ub, the lower end for lb, as the
// TPU kernel does.  The per-point terms are bit-equal to the plain version's
// (non-contracting intrinsics, the same order), so are the bisection's lo and
// hi; only the sums depend on the reduction order.
//
// What bounds it on an H100: issue slots of the distance loop on the blocks
// that run, 9 a (point, target) pair in the exact diff form (the bound that
// chip_smoke.py reports counts the 7 of an FMA-contracted loop); the
// bisection adds 25 passes of a compare and an add over 2·Np staged values
// per survivor, about 1 % of that.
//
// Design (trimmed_nodes_kernel):
// - One warp per node.  Lane L keeps the points n0 + L + 32·r (r < PPL =
//   tq / 32: 12, 8 or 4) of the current block in registers and reads each
//   target once as a broadcast float4, so a pair costs 9 + 1/PPL slots.
//   The block's clamped sum is a warp butterfly, so the screen test needs no
//   CTA barrier and each warp stops on its own node.
// - Persistent CTAs of W warps.  Up to kBtResidentMax targets are staged
//   once per CTA with cp.async and stay in shared memory (RES); above that
//   (mxu_max admits 32,768) each warp reads them from global memory, where
//   they stay in L1/L2.  Warps take nodes from a global counter, so a warp
//   that screens early takes the next node.
// - Each warp's [2, Np] scratch (8·Np bytes: 12 KB at Np = 1,536, 315 KB
//   at the trimmed full cert's whole source of 40,256 points) lives in a
//   global [warps in flight, 2, Np] buffer that the caller allocates from
//   the plan: the terms are written once and read by the bisection's 25
//   passes from L1/L2.  Shared memory holds only the resident targets, so
//   an SM keeps as many warps as its registers allow at any Np (in shared
//   memory the scratch left one warp an SM at Np = 16,384 and did not fit
//   above ~29,000 points).  The plan picks W for the most resident warps
//   per SM and caps the grid so the buffer stays under kBtScratchMax bytes.

#include <algorithm>

#include "common.cuh"

namespace goicp {

constexpr int kBtMaxWarps = 8;
constexpr int kBtResidentMax = 6144;  // targets resident in shared memory
constexpr int kBtUnroll = 4;          // targets loaded ahead per step
constexpr long long kBtScratchMax = 1LL << 30;  // bytes of the global scratch

template <int PPL, bool RES>
__global__ void __launch_bounds__(32 * kBtMaxWarps)
trimmed_nodes_kernel(const float* __restrict__ params,  // [B, 24]
                     int B,
                     const float* __restrict__ srcT,    // [8, Np]
                     int Np,
                     const float* __restrict__ wm,      // [Mp, 8]
                     int Mp, int h, int drop,
                     float* __restrict__ gscr,          // [grid·W, 2, Np]
                     int* __restrict__ next,            // node counter, 0
                     float* __restrict__ ub_out,        // [B]
                     float* __restrict__ lb_out) {      // [B]
  extern __shared__ float4 bt_smem[];
  constexpr int tq = 32 * PPL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4* tg = RES ? bt_smem : reinterpret_cast<const float4*>(wm);
  constexpr int step = RES ? 1 : 2;  // float4s per target row
  float* scr = gscr + (static_cast<size_t>(blockIdx.x) * (blockDim.x >> 5) + warp) * 2 * Np;
  if constexpr (RES) {
    for (int k = threadIdx.x; k < Mp; k += blockDim.x)
      cp_async16(bt_smem + k, wm + static_cast<size_t>(k) * 8);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  for (;;) {
    __syncwarp();  // the last node's bisection is done with scr
    int b = 0;
    if (lane == 0) b = atomicAdd(next, 1);
    b = __shfl_sync(0xffffffffu, b, 0);
    if (b >= B) break;
    const float* P = params + static_cast<size_t>(b) * 24;
    const float af = P[12], gt = P[13], slack = P[14];
    const float thresh_eff = P[15], tau = P[16];
    float acc = 0.f;
    for (int n0 = 0; n0 < Np; n0 += tq) {
      if (!(acc < thresh_eff)) break;  // uniform: every lane holds acc
      float qx[PPL], qy[PPL], qz[PPL], best[PPL];
#pragma unroll
      for (int r = 0; r < PPL; ++r) {
        const int i = n0 + lane + 32 * r;
        const float px = srcT[i], py = srcT[Np + i], pz = srcT[2 * Np + i];
        qx[r] = fadd(dot3(px, py, pz, P[0], P[1], P[2]), P[9]);
        qy[r] = fadd(dot3(px, py, pz, P[3], P[4], P[5]), P[10]);
        qz[r] = fadd(dot3(px, py, pz, P[6], P[7], P[8]), P[11]);
        best[r] = finf();
      }
      for (int m = 0; m < Mp; m += kBtUnroll) {
        float4 w[kBtUnroll];
#pragma unroll
        for (int u = 0; u < kBtUnroll; ++u) w[u] = tg[(m + u) * step];
#pragma unroll
        for (int u = 0; u < kBtUnroll; ++u)
#pragma unroll
          for (int r = 0; r < PPL; ++r)
            best[r] = fminf(best[r], dist2(w[u], qx[r], qy[r], qz[r]));
      }
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < PPL; ++r) {
        const int i = n0 + lane + 32 * r;
        const float pn = srcT[3 * Np + i], pv = srcT[4 * Np + i];
        float d_hi, c;
        point_terms(best[r], slack, af, pn, gt, d_hi, c);
        const float lt = fmul(c, c);
        const float pad = fmul(fsub(1.f, pv), kPadSentinel);
        scr[i] = fadd(fmul(fmul(d_hi, d_hi), pv), pad);
        scr[Np + i] = fadd(fmul(lt, pv), pad);
        s = fadd(s, fmul(fminf(lt, tau), pv));
      }
      acc = fadd(acc, warp_reduce<SumF>(s));
    }
    if (acc >= thresh_eff) {
      if (lane == 0) {
        ub_out[b] = kPadSentinel;
        lb_out[b] = fsub(acc, fmul(static_cast<float>(drop), tau));
      }
      continue;
    }
    __syncwarp();  // every lane's terms are in scr
    float up, down, up_l, down_l;
    warp_trimmed_bisect(scr, Np, h, up, down);
    warp_trimmed_bisect(scr + Np, Np, h, up_l, down_l);
    if (lane == 0) {
      ub_out[b] = up;      // upper end for the upper bound
      lb_out[b] = down_l;  // lower end for the lower bound
    }
  }
}

// The launch of one configuration: targets resident or not, W warps per
// CTA, dynamic shared memory and a persistent grid.
struct BtPlan {
  bool resident = false;
  int warps = 0, grid = 0;
  size_t smem = 0;
};

template <int PPL, bool RES>
cudaError_t bt_occupancy(int warps, size_t smem, int optin_dyn, int& occ) {
  auto kernel = trimmed_nodes_kernel<PPL, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin_dyn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, 32 * warps, smem);
  return err;
}

// W (forced, or the most resident warps per SM; ties to the larger CTA,
// which stages the targets fewer times) and the persistent grid.
template <int PPL>
cudaError_t bt_plan(int B, int Np, int Mp, int want_warps, BtPlan& p) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t per_warp = static_cast<size_t>(8) * Np;
  const size_t tgt = static_cast<size_t>(16) * Mp;
  p.resident = Mp <= kBtResidentMax && tgt <= static_cast<size_t>(optin);
  p.smem = p.resident ? tgt : 0;
  int best = 0;
  for (int w = 1; w <= kBtMaxWarps; ++w) {
    if (want_warps && w != want_warps) continue;
    int occ = 0;
    err = p.resident ? bt_occupancy<PPL, true>(w, p.smem, optin, occ)
                     : bt_occupancy<PPL, false>(w, p.smem, optin, occ);
    if (err != cudaSuccess) return err;
    if (occ * w >= best && occ > 0) {
      best = occ * w;
      p.warps = w;
      p.grid = occ * sms;
    }
  }
  if (best == 0) return cudaErrorInvalidConfiguration;
  long long grid = std::min<long long>(p.grid, (static_cast<long long>(B) + p.warps - 1) / p.warps);
  grid = std::min<long long>(grid, kBtScratchMax / (static_cast<long long>(per_warp) * p.warps));
  p.grid = static_cast<int>(std::max(1LL, grid));
  return cudaSuccess;
}

template <int PPL>
int launch_trimmed_nodes(const float* params, int B, const float* srcT, int Np,
                         const float* wm, int Mp, int warps, int h, int drop,
                         float* gscr, int* next, float* ub, float* lb, cudaStream_t st,
                         int* plan_out) {
  BtPlan p;
  cudaError_t err = bt_plan<PPL>(B, Np, Mp, warps, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan_out != nullptr) {
    plan_out[0] = p.resident;
    plan_out[1] = p.warps;
    plan_out[2] = p.grid;
    plan_out[3] = static_cast<int>(p.smem);
    return 0;
  }
  if (gscr == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaMemsetAsync(next, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.resident)
    trimmed_nodes_kernel<PPL, true><<<p.grid, 32 * p.warps, p.smem, st>>>(
        params, B, srcT, Np, wm, Mp, h, drop, gscr, next, ub, lb);
  else
    trimmed_nodes_kernel<PPL, false><<<p.grid, 32 * p.warps, p.smem, st>>>(
        params, B, srcT, Np, wm, Mp, h, drop, gscr, next, ub, lb);
  return static_cast<int>(cudaGetLastError());
}

int trimmed_nodes(const float* params, int B, const float* srcT, int Np,
                  const float* wm, int Mp, int tq, int warps, int h, int drop,
                  float* gscr, int* next, float* ub, float* lb, void* stream, int* plan_out) {
  if (B <= 0 || Np <= 0 || Mp <= 0 || Mp % kBtUnroll != 0 || tq <= 0 || Np % tq != 0 ||
      warps < 0 || warps > kBtMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tq) {
    case 128: return launch_trimmed_nodes<4>(params, B, srcT, Np, wm, Mp, warps, h, drop,
                                             gscr, next, ub, lb, st, plan_out);
    case 256: return launch_trimmed_nodes<8>(params, B, srcT, Np, wm, Mp, warps, h, drop,
                                             gscr, next, ub, lb, st, plan_out);
    case 384: return launch_trimmed_nodes<12>(params, B, srcT, Np, wm, Mp, warps, h, drop,
                                              gscr, next, ub, lb, st, plan_out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace goicp

// K5: (ub, lb) [B] for B nodes' parameter rows [B, 24], with point blocks of
// tq = 128, 256 or 384 (Np a multiple of tq), `warps` warps per CTA (0: the
// plan's pick), `gscr` the global scratch (grid·warps·2·Np floats of the
// plan) and `next` one int of scratch for the node counter.
extern "C" int goicp_bounds_nodes_trimmed(const float* params, int B,
                                          const float* srcT, int Np,
                                          const float* wm, int Mp, int tq,
                                          int warps, int h, int drop,
                                          float* gscr, int* next, float* ub, float* lb,
                                          void* stream) {
  return goicp::trimmed_nodes(params, B, srcT, Np, wm, Mp, tq, warps, h, drop, gscr, next, ub,
                              lb, stream, nullptr);
}

// K5's launch plan without a launch: out = (targets resident, warps per CTA,
// grid, dynamic shared bytes).
extern "C" int goicp_bounds_nodes_trimmed_plan(int B, int Np, int Mp, int tq, int warps,
                                               int* out) {
  return goicp::trimmed_nodes(nullptr, B, nullptr, Np, nullptr, Mp, tq, warps, 0, 0, nullptr,
                              nullptr, nullptr, nullptr, nullptr, out);
}
