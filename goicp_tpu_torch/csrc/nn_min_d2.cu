// K1: exact nearest neighbour (min |q - m|² and its argmin) on Hopper.
//
// Replaces the TPU kernel goicp_tpu/nn/mxu.py:_min_d2_kernel (called through
// _min_d2_padded with want_idx=True, from nearest_neighbor_mxu): for every
// query R_b·p + t_b, the minimum over all targets of |q - m|² in the "diff"
// form, and the index of the EARLIEST target reaching it (strict <, as the
// TPU kernel's cross-chunk merge at mxu.py:131-135).
//
// K4 is the same kernel with a null index (want_idx=False, from
// min_d2_nodes): B node poses (up to 8·se3_pop = 21,080 at the bunny's
// shapes) over the whole source cloud, the per-point distances that the
// R-rounds of the "mxu" backend deflate and (trimmed-)sum.  Its grid is
// Np/128 x B blocks, so it fills the card; bound by arithmetic as above.
//
// What bounds it on an H100: arithmetic.  Each (query, target) pair costs
// 3 subtractions, 3 multiplies, 2 adds and a compare-select, and the targets
// are read from shared memory as broadcasts, so device memory sees each
// input once.  Design: one thread per query keeps its running (min, argmin)
// in registers; the block stages the targets through shared memory, 1024 at
// a time as float4, and every thread walks the staged tile in order.  At the
// ICP shapes (8-64 poses x ~1.5k points against ~2k targets) the grid is
// 100-760 blocks of 128 threads, so the small in-round refines leave SMs
// idle; more work per thread and a split over targets are later work.

#include "common.cuh"

namespace goicp {

constexpr int kNnThreads = 128;
constexpr int kNnTile = 1024;

__global__ void __launch_bounds__(kNnThreads)
nn_min_d2_kernel(const float* __restrict__ params,   // [B, 16]
                 const float* __restrict__ srcT,     // [8, Np]
                 int Np,
                 const float* __restrict__ wm,       // [Mp, 8]
                 int Mp,
                 float* __restrict__ d2,             // [B, Np]
                 int* __restrict__ idx) {            // [B, Np] or null
  __shared__ float4 tile[kNnTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* P = params + static_cast<size_t>(b) * 16;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (i < Np) {
    px = srcT[i];
    py = srcT[Np + i];
    pz = srcT[2 * Np + i];
  }
  const float qx = fadd(dot3(px, py, pz, P[0], P[1], P[2]), P[9]);
  const float qy = fadd(dot3(px, py, pz, P[3], P[4], P[5]), P[10]);
  const float qz = fadd(dot3(px, py, pz, P[6], P[7], P[8]), P[11]);

  float best = __int_as_float(0x7f800000);  // +inf
  int bidx = 0;
  for (int m0 = 0; m0 < Mp; m0 += kNnTile) {
    const int n = min(kNnTile, Mp - m0);
    __syncthreads();
    stage_targets(tile, wm, m0, n);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float d = dist2(tile[k], qx, qy, qz);
      if (d < best) {
        best = d;
        bidx = m0 + k;
      }
    }
  }
  if (i < Np) {
    d2[static_cast<size_t>(b) * Np + i] = fmaxf(best, 0.f);
    if (idx != nullptr) idx[static_cast<size_t>(b) * Np + i] = bidx;
  }
}

}  // namespace goicp

// idx may be null (K4: min_d2_nodes, mxu.py:361, distances only).  B rows
// go out in launches of at most 65,535 (the grid's y limit).
extern "C" int goicp_nn_min_d2(const float* params, int B, const float* srcT,
                               int Np, const float* wm, int Mp, float* d2,
                               int* idx, void* stream) {
  constexpr int kMaxY = 65535;
  for (int b0 = 0; b0 < B; b0 += kMaxY) {
    const size_t off = static_cast<size_t>(b0) * Np;
    dim3 grid((Np + goicp::kNnThreads - 1) / goicp::kNnThreads, min(kMaxY, B - b0));
    goicp::nn_min_d2_kernel<<<grid, goicp::kNnThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        params + static_cast<size_t>(b0) * 16, srcT, Np, wm, Mp, d2 + off,
        idx == nullptr ? nullptr : idx + off);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
