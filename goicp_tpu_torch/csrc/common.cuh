// Shared helpers of the goicp_tpu_torch Hopper kernels.
//
// Every product and sum below is written with the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts
// into FMAs, and every fused multiply-add with __fmaf_rn where the plain
// version has one (nn/fused.py: fma).  The kernels then round exactly as
// the plain PyTorch versions in nn/fused.py do, so a kernel and its plain
// version agree bit for bit on every per-point distance and the same
// nearest target wins.  The cost in the "diff" form is two extra
// instructions per pair (9 instead of 7 with FMA contraction), a trade
// recorded in PERF.md.

#pragma once

#include <cuda_runtime.h>

namespace goicp {

constexpr int kMaxWarps = 32;   // block reductions hold one partial per warp
constexpr int kGrTile = 256;    // targets staged per pass by the grouped kernels
constexpr float kPadSentinel = 1e30f;  // screened ub; padded trimmed terms

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float finf() { return __int_as_float(0x7f800000); }

// ((x*r0 + y*r1) + z*r2): one row of R·p, in the JAX kernels' order.
__device__ __forceinline__ float dot3(float x, float y, float z,
                                      float r0, float r1, float r2) {
  return fadd(fadd(fmul(x, r0), fmul(y, r1)), fmul(z, r2));
}

// The distance forms of mxu.py's _min_d2_kernel (`variant=`): "diff" (the
// default, (m - q)·(m - q) by dist2), "exp" (|m|² - 2q·m by three FMAs,
// |q|² added after the min) and "dot" (the 8-wide contraction [m, 1, |m|²]
// · [-2q, |q|², 1]).  The exp and dot forms round as XLA's CPU build
// rounds the interpreted JAX kernel: it contracts each product into the sum
// that follows (dot3c), as nn/fused.py's plain versions do with fma.
enum Form : int { kDiff = 0, kExp = 1, kDot = 2 };

__device__ __forceinline__ float ffma(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// x*r0 + y*r1 + z*r2 as XLA's CPU build contracts it: fma(z, r2, fma(x, r0, y*r1)).
__device__ __forceinline__ float dot3c(float x, float y, float z,
                                       float r0, float r1, float r2) {
  return ffma(z, r2, ffma(x, r0, fmul(y, r1)));
}

// |w - q|² in the "diff" form of nn/mxu.py: ((dx² + dy²) + dz²).
__device__ __forceinline__ float dist2(float4 w, float qx, float qy, float qz) {
  float dx = fsub(w.x, qx), dy = fsub(w.y, qy), dz = fsub(w.z, qz);
  return fadd(fadd(fmul(dx, dx), fmul(dy, dy)), fmul(dz, dz));
}

// Asynchronous 16-byte copy from global to shared memory (cp.async, L2
// only); both addresses 16-byte aligned.  A group of copies is committed
// with cp_async_commit and awaited with cp_async_wait<N> (all but the N
// newest groups complete), then a barrier (__syncthreads(), or __syncwarp()
// for a warp's own copies) makes them visible.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The grouped kernels' separable form (mxu.py:_min_d2_grouped_kernel): for
// u = R_g·p and the group's 8 sibling translations t_j,
//     best[j] = min over m of (G[m] + b_j[m]),  b_j[m] = |t_j|² - 2 t_j·m,
// with the base plane G[m] = |u - m|² ("diff"), or |m|² - 2u·m ("exp": the
// caller passes (ux, uy, uz) = -2u, three FMAs; |u|² joins in
// grouped_d2_exp).  `gp` is the group's
// parameter row (R×9 at 0, t8×24 at 9, |t_j|²×8 at 33).  The CTA stages
// kGrTile targets at a time into `tw` (x, y, z, and |m|² for "exp"), with
// all 8 b_j[m] in `tb`, so b_j is computed once per (group, target) per
// CTA.  Every thread calls it (it syncs).
template <int FORM = kDiff>
__device__ __forceinline__ void grouped_min(float (&best)[8], float4* tw,
                                            float4 (*tb)[2], const float* gp,
                                            const float* wm, int Mp, float ux,
                                            float uy, float uz) {
#pragma unroll
  for (int j = 0; j < 8; ++j) best[j] = finf();
  for (int m0 = 0; m0 < Mp; m0 += kGrTile) {
    const int n = min(kGrTile, Mp - m0);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const float* w = wm + static_cast<size_t>(m0 + k) * 8;
      const float wx = w[0], wy = w[1], wz = w[2];
      tw[k] = make_float4(wx, wy, wz, FORM == kExp ? w[4] : 0.f);
      float b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s = FORM == kExp
            ? dot3c(gp[9 + 3 * j], gp[10 + 3 * j], gp[11 + 3 * j], wx, wy, wz)
            : dot3(gp[9 + 3 * j], gp[10 + 3 * j], gp[11 + 3 * j], wx, wy, wz);
        b[j] = fsub(gp[33 + j], fmul(2.f, s));
      }
      tb[k][0] = make_float4(b[0], b[1], b[2], b[3]);
      tb[k][1] = make_float4(b[4], b[5], b[6], b[7]);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 m = tw[k];
      const float G = FORM == kExp ? ffma(uz, m.z, ffma(uy, m.y, ffma(ux, m.x, m.w)))
                                   : dist2(m, ux, uy, uz);
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
}

// Sibling j's squared distance from its grouped minimum: max(best + a_j, 0)
// with a_j = 2 t_j·u, added after the min as in the TPU kernel ("exp":
// max(best + (a_j + |u|²), 0), with u itself and un = |u|²).
__device__ __forceinline__ float grouped_d2(const float* gp, int j, float best,
                                            float ux, float uy, float uz) {
  const float a = fmul(2.f, dot3(gp[9 + 3 * j], gp[10 + 3 * j], gp[11 + 3 * j],
                                 ux, uy, uz));
  return fmaxf(fadd(best, a), 0.f);
}
__device__ __forceinline__ float grouped_d2_exp(const float* gp, int j, float best,
                                                float ux, float uy, float uz, float un) {
  const float a = fmul(2.f, dot3c(gp[9 + 3 * j], gp[10 + 3 * j], gp[11 + 3 * j],
                                  ux, uy, uz));
  return fmaxf(fadd(best, fadd(a, un)), 0.f);
}

// Yang et al. eq. 10 per point, from the squared distance d2:
//   d_hi = d + slack,  c = max(max(d - slack, 0) - (af·|p| + γt), 0)
// (the ub term is d_hi², the lb term c²).
__device__ __forceinline__ void point_terms(float d2, float slack, float af,
                                            float pn, float gt, float& d_hi,
                                            float& c) {
  const float d = sqrtf(fmaxf(d2, 0.f));
  d_hi = fadd(d, slack);
  const float d_lo = fmaxf(fsub(d, slack), 0.f);
  c = fmaxf(fsub(d_lo, fadd(fmul(af, pn), gt)), 0.f);
}

struct SumF {
  __device__ static float op(float a, float b) { return fadd(a, b); }
};
struct SumI {
  __device__ static int op(int a, int b) { return a + b; }
};
struct MaxF {
  __device__ static float op(float a, float b) { return fmaxf(a, b); }
};

// K reductions over the CTA at once (blockDim.x a multiple of 32): a warp
// butterfly, lane 0 posts its warp's partial, and every thread folds the
// partials in warp order, so all threads return the same values and the
// order is fixed.  `red` is shared, K × kMaxWarps entries.
template <class Op, int K, typename T>
__device__ __forceinline__ void block_reduce(T (&v)[K], T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = Op::op(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
    if (lane == 0) red[k * kMaxWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T s = red[k * kMaxWarps];
    for (int w = 1; w < nwarps; ++w) s = Op::op(s, red[k * kMaxWarps + w]);
    v[k] = s;
  }
  __syncthreads();  // red is rewritten by the next call
}

// A reduction over the 32 lanes of a warp (xor butterfly).  Each step
// combines the same two values on both lanes of a pair, so with a
// commutative Op every lane returns the same bits.
template <class Op, typename T>
__device__ __forceinline__ T warp_reduce(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = Op::op(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The exact trimmed sum of one row x[0, n) (its h smallest entries) by the
// 24-step threshold bisection of mxu.py's trimmed kernels (= nn/fused.py:
// trimmed_sum_bisect), by the 32 lanes of one warp: hi starts at the largest
// non-sentinel entry + 1e-12, each step halves [lo, hi] on whether at least
// h entries are <= mid.  The counts are exact integers (reduced by
// warp_reduce, no CTA barrier), so lo and hi come out bit-equal to the
// plain version; only the final sum S depends on the reduction order.
// Returns S + (h - C)⁺·hi in `up` (the upper end) and S + (h - C)⁺·lo in
// `down` (the lower end), the same on every lane.  The warp's lanes must
// see x (a __syncwarp() or __syncthreads() after it was written).
__device__ __forceinline__ void warp_trimmed_bisect(const float* x, int n, int h,
                                                    float& up, float& down) {
  const int lane = threadIdx.x & 31;
  float m = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float v = x[i];
    m = fmaxf(m, v < 1e29f ? v : 0.f);
  }
  m = warp_reduce<MaxF>(m);
  float lo = 0.f, hi = fadd(m, 1e-12f);
  const float hf = static_cast<float>(h);
  for (int it = 0; it < 24; ++it) {
    const float mid = fmul(0.5f, fadd(lo, hi));
    int c = 0;
    for (int i = lane; i < n; i += 32) c += x[i] <= mid;
    const bool take = static_cast<float>(warp_reduce<SumI>(c)) >= hf;
    lo = take ? lo : mid;
    hi = take ? mid : hi;
  }
  float s = 0.f;
  int c = 0;
  for (int i = lane; i < n; i += 32) {
    const float v = x[i];
    if (v <= lo) {
      s = fadd(s, v);
      ++c;
    }
  }
  s = warp_reduce<SumF>(s);
  c = warp_reduce<SumI>(c);
  const float rem = fmaxf(fsub(hf, static_cast<float>(c)), 0.f);
  up = fadd(s, fmul(rem, hi));
  down = fadd(s, fmul(rem, lo));
}

}  // namespace goicp
