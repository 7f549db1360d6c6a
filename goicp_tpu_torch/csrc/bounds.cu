// K2: screened fused bounds of SE(3) nodes, one warp per (node, point block).
//
// Replaces the TPU kernel goicp_tpu/nn/mxu.py:_bounds_kernel (called through
// _bounds_padded from bounds_nodes).  For node b with pose (R, t), the
// per-point nearest distance d of q = R·p + t gives
//
//     ub += (d + slack)² · valid
//     lb += max(max(d - slack, 0) - (af·|p| + γt), 0)² · valid
//
// summed block by block over the source points.  Before each block the
// carried lb is tested against the node's threshold (incumbent − ε); once
// lb ≥ thresh the remaining blocks are skipped, since a partial sum of
// non-negative terms is already a valid lower bound.  A node with
// lb ≥ thresh reports ub = 1e30 (mxu.py:473), even when every block ran.
//
// The point-block size is the TPU kernel's, tq = _pick_tile(Np, 384): a
// screened node's lb is the partial sum at a block boundary, so another
// block size would give another (still valid) lb, another frontier order
// and other node counts than the JAX package.
//
// Summation order (nn/fused.py:bounds_nodes_kernel_order repeats it in
// plain PyTorch, bit for bit).  Lane L of the warp holds the points
// n0 + L + 32·r of the block, r < PPL = tq / 32.  For each r the 32 lanes'
// terms are added by an xor butterfly (offsets 16, 8, 4, 2, 1); the PPL
// partials are added in r order; the carried (ub, lb) then add the block's
// sums, block after block.  That is the order of the one-CTA-per-node
// kernel this one replaced (warp r of its CTA held the same 32 points), so
// the bounds, and the solver's node counts, did not move.
//
// What bounds it on an H100: issue slots of the distance loop on the blocks
// that run, 9 a (point, target) pair in the exact diff form (non-contracting
// intrinsics: the node counts rest on them; the bound that chip_smoke.py
// reports counts the 7 of an FMA-contracted loop, so 78 % is the ceiling).
// A node reads its 64-byte parameter row and writes two floats.
//
// Design:
// - The unit of work is one (node, block) item, done by one warp: PPL
//   points a lane in registers, each target read once as a broadcast
//   float4, so a pair costs 9 + 1/PPL slots.  The block sums need no CTA
//   barrier.
// - Persistent CTAs of W warps take items from one global counter in
//   block-major order (item = n·B + b: every node's block 0, then every
//   node's block 1, ...).  With many short nodes (the bunny's R-rounds,
//   21,080 nodes of 4 blocks) block n−1 of a node is long done when block n
//   is taken, so each node has one block in flight, as in a serial scan.
//   With few long nodes (the full cert's whole source, 792 nodes of 105
//   blocks) the warps in flight spread over about (warps / B) blocks of
//   each node, and a node whose screen falls frees its warps at once: the
//   skip turns into time saved wherever it happens, and no SM idles behind
//   one long node.
// - In-order carry.  A warp that finished block n of node b waits (lane 0,
//   a short sleep per poll) until the node's state says n, adds its sums to
//   the carried (ub, lb) in global memory, and publishes n + 1 with a
//   release store; the block before it was taken earlier and never waits on
//   a later one, so the chain always moves.  When the carried lb reaches
//   thresh, or after the last block, the warp writes the node's output and
//   marks it done; a warp that takes an item of a done node skips it, and a
//   warp whose block was already in flight finds the node done and drops
//   its sums.  The waste is the blocks in flight past the crossing, at most
//   the warps in flight per live node.
// - Targets: up to kBdResidentMax (96 KB) are staged once per CTA with
//   cp.async and stay in shared memory; above that (mxu_max admits 32,768)
//   each warp streams them through its own double-buffered ring of
//   kBdRing targets (cp.async), with no CTA barrier.

#include <algorithm>

#include "common.cuh"

namespace goicp {

constexpr int kBdMaxWarps = 8;
constexpr int kBdResidentMax = 6144;   // targets resident in shared memory
constexpr int kBdRing = 256;           // targets per ring slot (two slots a warp)
constexpr int kBdUnroll = 4;           // targets loaded ahead per step
constexpr int kBdDone = 0x7fffffff;    // a node's state once its output is written

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// best[r] = min(best[r], |t[m] - q_r|²) over the n targets t[0..n).
template <int PPL>
__device__ __forceinline__ void scan_targets(const float4* t, int n, const float (&qx)[PPL],
                                             const float (&qy)[PPL], const float (&qz)[PPL],
                                             float (&best)[PPL]) {
  for (int m = 0; m < n; m += kBdUnroll) {
    float4 w[kBdUnroll];
#pragma unroll
    for (int u = 0; u < kBdUnroll; ++u) w[u] = t[m + u];
#pragma unroll
    for (int u = 0; u < kBdUnroll; ++u)
#pragma unroll
      for (int r = 0; r < PPL; ++r) best[r] = fminf(best[r], dist2(w[u], qx[r], qy[r], qz[r]));
  }
}

template <int PPL, bool RES>
__global__ void __launch_bounds__(32 * kBdMaxWarps)
bounds_kernel(const float* __restrict__ params,  // [B, 16]
              int B,
              const float* __restrict__ srcT,    // [8, Np] x,y,z,|p|,valid
              int Np,
              const float* __restrict__ wm,      // [Mp, 8]
              int Mp, int nb,
              int* __restrict__ state,           // [B + 1], zeroed: item counter, node states
              float2* __restrict__ carry,        // [B] carried (ub, lb)
              float* __restrict__ ub_out,        // [B]
              float* __restrict__ lb_out) {      // [B]
  extern __shared__ float4 bd_smem[];
  constexpr int tq = 32 * PPL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* next = state;
  int* node = state + 1;
  float4* ring = bd_smem + static_cast<size_t>(warp) * 2 * kBdRing;  // !RES only
  if constexpr (RES) {
    for (int k = threadIdx.x; k < Mp; k += blockDim.x)
      cp_async16(bd_smem + k, wm + static_cast<size_t>(k) * 8);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const int items = B * nb;
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(next, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    if (item >= items) break;
    const int n = item / B, b = item - n * B;
    const float* P = params + static_cast<size_t>(b) * 16;
    const float thresh = P[15];
    int st = 0;
    if (lane == 0 && n > 0) st = ld_relaxed(node + b);
    if (__shfl_sync(0xffffffffu, st, 0) == kBdDone) continue;  // screened: skip the block
    if (n == 0 && !(0.f < thresh)) {  // screened before its first block
      if (lane == 0) {
        ub_out[b] = kPadSentinel;
        lb_out[b] = 0.f;
        st_release(node + b, kBdDone);
      }
      continue;
    }
    const float af = P[12], gt = P[13], slack = P[14];
    const int n0 = n * tq;
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
    if constexpr (RES) {
      scan_targets<PPL>(bd_smem, Mp, qx, qy, qz, best);
    } else {
      const int ntile = (Mp + kBdRing - 1) / kBdRing;
      auto stage = [&](int slot, int m0) {
        const int cnt = min(kBdRing, Mp - m0);
        for (int k = lane; k < cnt; k += 32)
          cp_async16(ring + slot * kBdRing + k, wm + static_cast<size_t>(m0 + k) * 8);
        cp_async_commit();
      };
      stage(0, 0);
      for (int j = 0; j < ntile; ++j) {
        if (j + 1 < ntile) {
          stage((j + 1) & 1, (j + 1) * kBdRing);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        scan_targets<PPL>(ring + (j & 1) * kBdRing, min(kBdRing, Mp - j * kBdRing), qx, qy,
                          qz, best);
        __syncwarp();  // the slot is restaged next
      }
    }
    float u = 0.f, l = 0.f;
#pragma unroll
    for (int r = 0; r < PPL; ++r) {
      const int i = n0 + lane + 32 * r;
      const float pn = srcT[3 * Np + i], pv = srcT[4 * Np + i];
      float d_hi, c;
      point_terms(best[r], slack, af, pn, gt, d_hi, c);
      const float ur = warp_reduce<SumF>(fmul(fmul(d_hi, d_hi), pv));
      const float lr = warp_reduce<SumF>(fmul(fmul(c, c), pv));
      u = r == 0 ? ur : fadd(u, ur);
      l = r == 0 ? lr : fadd(l, lr);
    }
    if (lane == 0) {  // add the block in order: wait for block n − 1's carry
      int s;
      while ((s = ld_acquire(node + b)) != n && s != kBdDone) __nanosleep(100);
      if (s == n) {
        float ub = 0.f, lb = 0.f;
        if (n > 0) {
          const float2 cv = __ldcg(carry + b);
          ub = cv.x;
          lb = cv.y;
        }
        ub = fadd(ub, u);
        lb = fadd(lb, l);
        if (!(lb < thresh) || n + 1 == nb) {
          ub_out[b] = lb < thresh ? ub : kPadSentinel;
          lb_out[b] = lb;
          st_release(node + b, kBdDone);
        } else {
          __stcg(carry + b, make_float2(ub, lb));
          st_release(node + b, n + 1);
        }
      }
    }
    __syncwarp();
  }
}

// The launch of one configuration: targets resident or streamed through
// each warp's ring, W warps per CTA, dynamic shared memory, persistent grid.
struct BdPlan {
  bool resident = false;
  int warps = 0, grid = 0;
  size_t smem = 0;
};

template <int PPL, bool RES>
cudaError_t bd_occupancy(int warps, size_t smem, int optin, int& occ) {
  auto kernel = bounds_kernel<PPL, RES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, 32 * warps, smem);
  return err;
}

// route: 0 = targets resident up to kBdResidentMax, else the ring; 1 =
// resident (refused where they do not fit); 2 = the ring.  want_warps and
// want_grid (0: the plan's pick) force W and the number of CTAs (capped at
// what stays resident on the card).
template <int PPL>
cudaError_t bd_plan(int B, int nb, int Mp, int want_warps, int want_grid, int route,
                    BdPlan& p) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  p.resident = route == 1 || (route == 0 && Mp <= kBdResidentMax);
  int best = 0;
  for (int w = 1; w <= kBdMaxWarps; ++w) {
    if (want_warps && w != want_warps) continue;
    const size_t smem = p.resident ? static_cast<size_t>(16) * Mp
                                   : static_cast<size_t>(w) * 2 * kBdRing * 16;
    if (smem > static_cast<size_t>(optin)) break;
    int occ = 0;
    err = p.resident ? bd_occupancy<PPL, true>(w, smem, optin, occ)
                     : bd_occupancy<PPL, false>(w, smem, optin, occ);
    if (err != cudaSuccess) return err;
    if (occ * w >= best && occ > 0) {  // ties: the larger CTA stages less
      best = occ * w;
      p.warps = w;
      p.smem = smem;
      p.grid = occ * sms;
    }
  }
  if (best == 0) return cudaErrorInvalidConfiguration;
  const long long need = (static_cast<long long>(B) * nb + p.warps - 1) / p.warps;
  long long grid = std::min<long long>(p.grid, need);
  if (want_grid > 0) grid = std::min<long long>(grid, want_grid);
  p.grid = static_cast<int>(std::max(1LL, grid));
  return cudaSuccess;
}

template <int PPL>
int launch_bounds(const float* params, int B, const float* srcT, int Np, const float* wm,
                  int Mp, int warps, int grid, int route, int* state, float* carry, float* ub,
                  float* lb, cudaStream_t st, int* plan_out) {
  const int nb = Np / (32 * PPL);
  BdPlan p;
  cudaError_t err = bd_plan<PPL>(B, nb, Mp, warps, grid, route, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan_out != nullptr) {
    plan_out[0] = p.resident;
    plan_out[1] = p.warps;
    plan_out[2] = p.grid;
    plan_out[3] = static_cast<int>(p.smem);
    return 0;
  }
  if (static_cast<long long>(B) * nb + static_cast<long long>(p.grid) * p.warps >= kBdDone)
    return static_cast<int>(cudaErrorInvalidValue);  // the item counter must not overflow
  err = cudaMemsetAsync(state, 0, sizeof(int) * (static_cast<size_t>(B) + 1), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  float2* cv = reinterpret_cast<float2*>(carry);
  if (p.resident)
    bounds_kernel<PPL, true><<<p.grid, 32 * p.warps, p.smem, st>>>(
        params, B, srcT, Np, wm, Mp, nb, state, cv, ub, lb);
  else
    bounds_kernel<PPL, false><<<p.grid, 32 * p.warps, p.smem, st>>>(
        params, B, srcT, Np, wm, Mp, nb, state, cv, ub, lb);
  return static_cast<int>(cudaGetLastError());
}

int bounds_nodes(const float* params, int B, const float* srcT, int Np, const float* wm,
                 int Mp, int tq, int warps, int grid, int route, int* state, float* carry,
                 float* ub, float* lb, void* stream, int* plan_out) {
  if (B <= 0 || Np <= 0 || Mp <= 0 || Mp % kBdUnroll != 0 || tq <= 0 || Np % tq != 0 ||
      warps < 0 || warps > kBdMaxWarps || grid < 0 || route < 0 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tq) {
    case 128: return launch_bounds<4>(params, B, srcT, Np, wm, Mp, warps, grid, route, state,
                                      carry, ub, lb, st, plan_out);
    case 256: return launch_bounds<8>(params, B, srcT, Np, wm, Mp, warps, grid, route, state,
                                      carry, ub, lb, st, plan_out);
    case 384: return launch_bounds<12>(params, B, srcT, Np, wm, Mp, warps, grid, route, state,
                                       carry, ub, lb, st, plan_out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace goicp

// K2: (ub, lb) [B] for B nodes' parameter rows [B, 16], with point blocks of
// tq = 128, 256 or 384 (Np a multiple of tq); `warps`, `grid` and `route`
// force the plan (0: its pick; route 1 resident targets, 2 the ring);
// `state` is B + 1 ints and `carry` 2·B floats of scratch.
extern "C" int goicp_bounds_nodes(const float* params, int B, const float* srcT, int Np,
                                  const float* wm, int Mp, int tq, int warps, int grid,
                                  int route, int* state, float* carry, float* ub, float* lb,
                                  void* stream) {
  return goicp::bounds_nodes(params, B, srcT, Np, wm, Mp, tq, warps, grid, route, state, carry,
                             ub, lb, stream, nullptr);
}

// K2's launch plan without a launch: out = (targets resident, warps per CTA,
// grid, dynamic shared bytes).
extern "C" int goicp_bounds_nodes_plan(int B, int Np, int Mp, int tq, int warps, int grid,
                                       int route, int* out) {
  return goicp::bounds_nodes(nullptr, B, nullptr, Np, nullptr, Mp, tq, warps, grid, route,
                             nullptr, nullptr, nullptr, nullptr, nullptr, out);
}
