// K6: screened fused TRIMMED bounds for 8 translation siblings per rotation.
//
// Replaces the TPU kernel goicp_tpu/nn/mxu.py:_bounds_trimmed_grouped_kernel
// (called through _bounds_trimmed_grouped_padded from bounds_groups_trimmed):
// the grouped twin of K5 (bounds_trimmed.cu).
//   - The distances come in K3's separable form: for u = R_g·p,
//     best_j = min over m of (|u - m|² + b_j[m]), b_j[m] = |t_j|² - 2 t_j·m,
//     then d2_j = max(best_j + 2 t_j·u, 0) (common.cuh: grouped_d2), in the
//     same order, so every per-point term is bit-equal to the plain version's.
//   - Each sibling carries its own clamped sum Σ min(l, τ)·valid over point
//     blocks of tq = _pick_tile(Np, 384), tested before each block in point
//     order; the next block is skipped once EVERY sibling's sum reaches
//     thresh' (slot 51), as the TPU kernel does.  A screened group reports
//     ub = 1e30 and lb = Σl̃ - drop·τ per sibling and skips the bisection; a
//     masked group (thresh' = -inf) stops before its first block.
//   - Survivors reduce all 16 rows of terms (8 ub rows, 8 lb rows, pad lanes
//     at 1e30) by the 24-step bisection.
// Parameter row [64]: R×9, t8×24, |t_j|²×8, af (41), γt×8 (42-49), slack
// (50), thresh' (51), τ (52).
//
// What bounds it on an H100: issue slots of the grouped loop on the blocks
// that run, 24 FP operations a (point, target) for the 8 siblings (the bound
// chip_smoke.py reports counts 22); the bisection adds 25 passes over 16·Np
// staged values per surviving group.
//
// Design (trimmed_groups_kernel):
// - Persistent CTAs of tq/QR threads (128 at every tq the wrapper picks)
//   take groups from a global counter.  A thread keeps QR points of the
//   block (with their 8 running minima each) in registers, so each staged
//   target's float4 and its two float4 of b_j serve QR points: 24 + 3/QR
//   slots a pair.
// - Targets stream through a double-buffered tile of kGtTile targets with
//   their 8 b_j, computed by the CTA once per tile and block; the next
//   tile's rows are loaded into registers while the current one is scanned,
//   so one barrier per tile suffices.  Shared memory stays at ~25 KB, and
//   registers, not the scratch, set the occupancy.
// - The 16 rows of terms go to a [16, Np] slot of a global buffer per CTA
//   ([grid, 16, Np], L2-resident at the bunny's shapes), so any Np fits.
//   The block's 8 clamped sums reduce in one block_reduce.
// - The bisection gives one row to each warp in turn (common.cuh:
//   warp_trimmed_bisect): counts from registers and shuffles, no CTA-wide
//   reduction in any of its 25 passes; the row comes from L1/L2.

#include <algorithm>

#include "common.cuh"

namespace goicp {

constexpr int kGtTile = 256;     // targets per tile
constexpr int kGtMinThreads = 64;
constexpr int kGtMaxThreads = 384;
constexpr int kGtRows = kGtTile / kGtMinThreads;  // tile rows a thread loads, at most

// Load the target rows [m0, m0 + n) that this thread stages.
__device__ __forceinline__ void gt_load(float4 (&w)[kGtRows], const float* wm, int m0, int n) {
#pragma unroll
  for (int a = 0; a < kGtRows; ++a) {
    const int k = threadIdx.x + a * blockDim.x;
    if (k < n) w[a] = *reinterpret_cast<const float4*>(wm + static_cast<size_t>(m0 + k) * 8);
  }
}

// Store them as (x, y, z, 0) with their 8 b_j (as in common.cuh: grouped_min).
__device__ __forceinline__ void gt_store(const float4 (&w)[kGtRows], int n, float4* tw,
                                         float4 (*tb)[2], const float* gp) {
#pragma unroll
  for (int a = 0; a < kGtRows; ++a) {
    const int k = threadIdx.x + a * blockDim.x;
    if (k >= n) continue;
    tw[k] = make_float4(w[a].x, w[a].y, w[a].z, 0.f);
    float b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float s = dot3(gp[9 + 3 * j], gp[10 + 3 * j], gp[11 + 3 * j], w[a].x, w[a].y, w[a].z);
      b[j] = fsub(gp[33 + j], fmul(2.f, s));
    }
    tb[k][0] = make_float4(b[0], b[1], b[2], b[3]);
    tb[k][1] = make_float4(b[4], b[5], b[6], b[7]);
  }
}

template <int QR>
__global__ void __launch_bounds__(kGtMaxThreads)
trimmed_groups_kernel(const float* __restrict__ gparams,  // [G, 64]
                      int G,
                      const float* __restrict__ srcT,     // [8, Np]
                      int Np,
                      const float* __restrict__ wm,       // [Mp, 8]
                      int Mp, int h, int drop,
                      float* __restrict__ scratch,        // [gridDim.x, 16, Np]
                      int* __restrict__ next,             // group counter, 0
                      float* __restrict__ ub_out,         // [8G]
                      float* __restrict__ lb_out) {       // [8G]
  __shared__ float4 tw[2][kGtTile];
  __shared__ float4 tb[2][kGtTile][2];
  __shared__ float gp[64];
  __shared__ float red[8 * kMaxWarps];
  __shared__ int grp;
  const int nthr = blockDim.x, tq = nthr * QR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = nthr >> 5;
  const int nt = (Mp + kGtTile - 1) / kGtTile;
  float* scr = scratch + static_cast<size_t>(blockIdx.x) * 16 * Np;
  for (;;) {
    if (threadIdx.x == 0) grp = atomicAdd(next, 1);
    __syncthreads();  // also: the last group's bisection is done with scr
    const int g = grp;
    if (g >= G) break;
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
      float ux[QR], uy[QR], uz[QR], best[QR][8];
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        const int i = n0 + threadIdx.x + nthr * r;
        const float px = srcT[i], py = srcT[Np + i], pz = srcT[2 * Np + i];
        ux[r] = dot3(px, py, pz, gp[0], gp[1], gp[2]);
        uy[r] = dot3(px, py, pz, gp[3], gp[4], gp[5]);
        uz[r] = dot3(px, py, pz, gp[6], gp[7], gp[8]);
#pragma unroll
        for (int j = 0; j < 8; ++j) best[r][j] = finf();
      }
      float4 w[kGtRows];
      gt_load(w, wm, 0, min(kGtTile, Mp));
      gt_store(w, min(kGtTile, Mp), tw[0], tb[0], gp);
      __syncthreads();
      for (int t = 0; t < nt; ++t) {
        const int m0 = t * kGtTile, n = min(kGtTile, Mp - m0);
        const int n_next = min(kGtTile, Mp - m0 - kGtTile);
        if (t + 1 < nt) gt_load(w, wm, m0 + kGtTile, n_next);
        const float4* cw = tw[t & 1];
        const float4(*cb)[2] = tb[t & 1];
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const float4 m = cw[k], b0 = cb[k][0], b1 = cb[k][1];
#pragma unroll
          for (int r = 0; r < QR; ++r) {
            const float Gd = dist2(m, ux[r], uy[r], uz[r]);
            best[r][0] = fminf(best[r][0], fadd(Gd, b0.x));
            best[r][1] = fminf(best[r][1], fadd(Gd, b0.y));
            best[r][2] = fminf(best[r][2], fadd(Gd, b0.z));
            best[r][3] = fminf(best[r][3], fadd(Gd, b0.w));
            best[r][4] = fminf(best[r][4], fadd(Gd, b1.x));
            best[r][5] = fminf(best[r][5], fadd(Gd, b1.y));
            best[r][6] = fminf(best[r][6], fadd(Gd, b1.z));
            best[r][7] = fminf(best[r][7], fadd(Gd, b1.w));
          }
        }
        if (t + 1 < nt) gt_store(w, n_next, tw[(t + 1) & 1], tb[(t + 1) & 1], gp);
        __syncthreads();  // tile t+1 staged; tile t free for t+2
      }
      float s[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = 0.f;
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        const int i = n0 + threadIdx.x + nthr * r;
        const float pn = srcT[3 * Np + i], pv = srcT[4 * Np + i];
        const float pad = fmul(fsub(1.f, pv), kPadSentinel);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float d_hi, c;
          point_terms(grouped_d2(gp, j, best[r][j], ux[r], uy[r], uz[r]), slack, af, pn,
                      gp[42 + j], d_hi, c);
          const float lt = fmul(c, c);
          scr[static_cast<size_t>(j) * Np + i] = fadd(fmul(fmul(d_hi, d_hi), pv), pad);
          scr[static_cast<size_t>(8 + j) * Np + i] = fadd(fmul(lt, pv), pad);
          s[j] = fadd(s[j], fmul(fminf(lt, tau), pv));
        }
      }
      block_reduce<SumF>(s, red);  // its __syncthreads also publishes scr
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
      continue;
    }
    for (int row = warp; row < 16; row += nwarps) {
      float up, down;
      warp_trimmed_bisect(scr + static_cast<size_t>(row) * Np, Np, h, up, down);
      if (lane == 0) {
        if (row < 8) ub_out[static_cast<size_t>(g) * 8 + row] = up;  // ub rows: upper end
        else lb_out[static_cast<size_t>(g) * 8 + row - 8] = down;     // lb rows: lower end
      }
    }
  }
}

template <int QR>
cudaError_t gt_ctas(int threads, int& ctas) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, trimmed_groups_kernel<QR>, threads, 0);
  ctas = sms * occ;
  return err == cudaSuccess && occ == 0 ? cudaErrorInvalidConfiguration : err;
}

bool gt_shape_ok(int tq, int qr) {
  if (qr < 1 || qr > 3 || tq <= 0 || tq % (32 * qr) != 0) return false;
  const int threads = tq / qr;
  return threads >= kGtMinThreads && threads <= kGtMaxThreads;
}

}  // namespace goicp

// K6's persistent CTAs on this card for point blocks of tq with qr points
// per thread (tq/qr threads a CTA, 64 to 384; qr 1-3): SMs x occupancy, or
// 0 for a shape it does not take.  The caller launches min(G, this) CTAs and
// passes a [grid, 16, Np] scratch.
extern "C" int goicp_bounds_groups_trimmed_ctas(int tq, int qr) {
  if (!goicp::gt_shape_ok(tq, qr)) return 0;
  int ctas = 0;
  cudaError_t err = cudaSuccess;
  switch (qr) {
    case 1: err = goicp::gt_ctas<1>(tq, ctas); break;
    case 2: err = goicp::gt_ctas<2>(tq / 2, ctas); break;
    default: err = goicp::gt_ctas<3>(tq / 3, ctas); break;
  }
  return err == cudaSuccess ? ctas : 0;
}

// K6: (ub, lb) [8G] for G groups' parameter rows [G, 64], point blocks of tq
// (Np a multiple of tq), qr points per thread, `grid` CTAs over the scratch
// [grid, 16, Np] and `next` one int of scratch for the group counter.
extern "C" int goicp_bounds_groups_trimmed(const float* gparams, int G,
                                           const float* srcT, int Np,
                                           const float* wm, int Mp, int tq, int qr,
                                           int h, int drop, int grid, float* scratch,
                                           int* next, float* ub, float* lb, void* stream) {
  using namespace goicp;
  if (G <= 0 || Np <= 0 || Mp <= 0 || grid <= 0 || !gt_shape_ok(tq, qr) || Np % tq != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(next, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = tq / qr;
  switch (qr) {
    case 1:
      trimmed_groups_kernel<1><<<grid, threads, 0, st>>>(gparams, G, srcT, Np, wm, Mp, h, drop,
                                                         scratch, next, ub, lb);
      break;
    case 2:
      trimmed_groups_kernel<2><<<grid, threads, 0, st>>>(gparams, G, srcT, Np, wm, Mp, h, drop,
                                                         scratch, next, ub, lb);
      break;
    default:
      trimmed_groups_kernel<3><<<grid, threads, 0, st>>>(gparams, G, srcT, Np, wm, Mp, h, drop,
                                                         scratch, next, ub, lb);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
