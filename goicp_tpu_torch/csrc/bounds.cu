// K2: screened fused bounds, one CTA per SE(3) node.
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
// The point-block size is the TPU kernel's, tq = _pick_tile(Np, 384), and
// each block is reduced CTA-wide before the test: a screened node's lb is the
// partial sum at a block boundary, so another block size would give another
// (still valid) lb, another frontier order and other node counts than the
// JAX package.
//
// What bounds it on an H100: arithmetic on the blocks that run (9 operations
// per (point, target) pair as written, 7 with FMAs), never memory: a node
// reads its 64-byte parameter row and writes two floats.  Design: blockDim =
// tq, one thread per point of the current block, targets staged 512 at a
// time through shared memory as float4; the block sums go through warp
// shuffles and a fixed-order pass over the warp partials (block_reduce), so
// every thread holds the same carried (ub, lb) and the skip test is uniform.

#include "common.cuh"

namespace goicp {

constexpr int kBdMaxThreads = 384;
constexpr int kBdTile = 512;

__global__ void __launch_bounds__(kBdMaxThreads)
bounds_kernel(const float* __restrict__ params,  // [B, 16]
              const float* __restrict__ srcT,    // [8, Np] x,y,z,|p|,valid
              int Np,
              const float* __restrict__ wm,      // [Mp, 8]
              int Mp,
              float* __restrict__ ub_out,        // [B]
              float* __restrict__ lb_out) {      // [B]
  __shared__ float4 tile[kBdTile];
  __shared__ float red[2 * kMaxWarps];
  const int b = blockIdx.x;
  const int tq = blockDim.x;
  const float* P = params + static_cast<size_t>(b) * 16;
  const float af = P[12], gt = P[13], slack = P[14], thresh = P[15];

  float ub_acc = 0.f, lb_acc = 0.f;
  for (int n0 = 0; n0 < Np; n0 += tq) {
    if (!(lb_acc < thresh)) break;  // uniform: every thread holds lb_acc
    const int i = n0 + threadIdx.x;
    const float px = srcT[i], py = srcT[Np + i], pz = srcT[2 * Np + i];
    const float pn = srcT[3 * Np + i], pv = srcT[4 * Np + i];
    const float qx = fadd(dot3(px, py, pz, P[0], P[1], P[2]), P[9]);
    const float qy = fadd(dot3(px, py, pz, P[3], P[4], P[5]), P[10]);
    const float qz = fadd(dot3(px, py, pz, P[6], P[7], P[8]), P[11]);
    float d_hi, c;
    point_terms(min_dist2<kBdTile>(tile, wm, Mp, qx, qy, qz), slack, af, pn, gt,
                d_hi, c);
    float s[2] = {fmul(fmul(d_hi, d_hi), pv), fmul(fmul(c, c), pv)};
    block_reduce<SumF>(s, red);
    ub_acc = fadd(ub_acc, s[0]);
    lb_acc = fadd(lb_acc, s[1]);
  }
  if (threadIdx.x == 0) {
    ub_out[b] = lb_acc < thresh ? ub_acc : kPadSentinel;
    lb_out[b] = lb_acc;
  }
}

}  // namespace goicp

extern "C" int goicp_bounds_nodes(const float* params, int B, const float* srcT,
                                  int Np, const float* wm, int Mp, int tq,
                                  float* ub, float* lb, void* stream) {
  goicp::bounds_kernel<<<B, tq, 0, static_cast<cudaStream_t>(stream)>>>(
      params, srcT, Np, wm, Mp, ub, lb);
  return static_cast<int>(cudaGetLastError());
}
