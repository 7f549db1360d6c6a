// K1 and K4: exact minimum squared distances to a target cloud on Hopper.
//
// Replace the TPU kernel goicp_tpu/nn/mxu.py:_min_d2_kernel (called through
// _min_d2_padded), in its uses:
//   K4  min_d2_nodes_kernel<4, false, FORM> (want_idx=False, from
//       min_d2_nodes): for B node poses (up to 8·se3_pop = 21,080 at the
//       bunny's shapes) over the source srcT [8, Np], d2[b, i] = min over
//       targets of |m - (R_b p_i + t_b)|², clamped at 0: the per-point
//       distances of the R-rounds of the "mxu" backend.
//   K1  nn_query_kernel (want_idx=True, from nearest_neighbor_mxu): for Q
//       query points q [Q, 3], the earliest target index reaching the
//       minimum (strict <, as the TPU kernel's cross-chunk merge at
//       mxu.py:131-135), clamped to Nt - 1, and d2 = |q - m_idx|², which is
//       the minimum itself bit for bit (recomputed from the target only when
//       clamped or not finite): every ICP iteration, 8 poses x 1,518 points
//       in each in-round refine of the bunny solve.
//   K1 over node poses: min_d2_nodes_kernel<QR, true, FORM> (want_idx=True
//       with node params, from min_d2_padded): d2 and the earliest index at
//       the minimum, unclamped, as _min_d2_padded returns them.
// FORM is the TPU kernel's `variant`: kDiff (every solver path), kExp and
// kDot (common.cuh: Form; min_d2_nodes(variant=), min_d2_padded).
//
// What bounds them on an H100: issue slots.  In the diff form a (query,
// target) pair costs 3 subtractions, 3 multiplies and 2 adds in the exact
// ((dx²+dy²)+dz²) order of the plain versions (non-contracting __f*_rn, so
// results are bit-equal) and one fminf: 9 slots, against the 7 an
// FMA-contracted kernel would issue (the bound chip_smoke.py reports).  The
// exp form costs 3 FMAs and the min (4), with |q|² added after the min;
// the dot form a multiply, 2 FMAs, 2 adds and the min (6): its 8-wide
// contraction [m, 1, |m|², 0…]·[-2q, |q|², 1, 0…] with the zero terms
// dropped, summed in the order XLA's CPU dot sums it.  Device memory sees
// each input once.
//
// Design, shared by all (min_d2_body):
// - Register blocking.  A thread keeps QR queries in registers (-2q and |q|²
//   for exp and dot) and reads each target once from shared memory as a
//   broadcast float4: (x, y, z, ·) for diff, (x, y, z, |m|²) for exp and
//   dot.  K4 (QR = 4) keeps only running minima (fminf).
// - The index at fminf's price.  K1 takes the minimum over a chunk of 8
//   targets, then one compare-select per chunk keeps the earliest chunk
//   holding the running minimum; at the end it finds the first target of
//   that chunk at exactly the minimum (the same arithmetic gives the same
//   bits).
// - Target splits for small Q.  A CTA's 8 warps are (8/S) query warps x S
//   target splits: the S warps of a query group walk disjoint slices of
//   every target tile and merge (d2, index) through shared memory, the
//   lower index winning a tie.  nn/fused.py:nn_route picks S and QR: an
//   in-round refine (12,144 queries) runs S = 8, QR = 1, so its 380 CTAs of
//   32 queries spread over the 132 SMs; the multistart's larger batches run
//   S = 4, QR = 4.  A launch as small as a refine's also pays for its
//   launch, its staging and its merge (PERF.md holds the times).
// - Persistent CTAs.  The grid is min(work items, SMs x occupancy); a CTA
//   walks items of (8/S)·32·QR consecutive queries (K4: flat b·Np + i).  Up
//   to kResidentMax targets (96 KB) are staged once per CTA with cp.async
//   and stay resident; above that (mxu_max admits 32,768) each item streams
//   them through a double-buffered ring of kRingTile targets.
// - A 1-D grid, so any B·Np fits one launch.
// Targets come as rows of `ld` floats whose first three are x, y, z: K4
// reads wm [Mp, 8] (ld 8; |m|² in column 4), K1 the [Mp, 4] copy that its
// caller packs once per target cloud (ld 4), which halves the bytes each
// CTA stages.

#include <algorithm>

#include "common.cuh"

namespace goicp {

constexpr int kNnWarps = 8;
constexpr int kNnThreads = 32 * kNnWarps;
constexpr int kChunk = 8;            // targets per min-then-compare step (K1)
constexpr int kResidentMax = 6144;   // targets resident in shared memory
constexpr int kRingTile = 2048;      // targets per ring buffer above that
constexpr int kK4Qr = 4;             // K4's queries per thread

// K4's queries: q = R_b·p_i + t_b for the flat index f = b·Np + i, each
// row of R·p in the JAX kernels' order (dot3), or contracted as XLA's CPU
// build contracts the interpreted exp and dot forms (dot3c).
struct NodeQueries {
  static constexpr bool kNearest = false;
  const float* params;  // [B, 16]
  const float* srcT;    // [8, Np]
  int Np;
  template <int FORM>
  __device__ __forceinline__ void load(long long f, float& qx, float& qy,
                                       float& qz) const {
    const int b = static_cast<int>(f / Np);
    const int i = static_cast<int>(f - static_cast<long long>(b) * Np);
    const float* P = params + static_cast<size_t>(b) * 16;
    const float px = srcT[i], py = srcT[Np + i], pz = srcT[2 * Np + i];
    if (FORM == kDiff) {
      qx = fadd(dot3(px, py, pz, P[0], P[1], P[2]), P[9]);
      qy = fadd(dot3(px, py, pz, P[3], P[4], P[5]), P[10]);
      qz = fadd(dot3(px, py, pz, P[6], P[7], P[8]), P[11]);
    } else {
      qx = fadd(dot3c(px, py, pz, P[0], P[1], P[2]), P[9]);
      qy = fadd(dot3c(px, py, pz, P[3], P[4], P[5]), P[10]);
      qz = fadd(dot3c(px, py, pz, P[6], P[7], P[8]), P[11]);
    }
  }
};

// K1's queries: the points themselves, [Q, 3] (diff form only).
struct PointQueries {
  static constexpr bool kNearest = true;
  const float* q;
  template <int FORM>
  __device__ __forceinline__ void load(long long f, float& qx, float& qy,
                                       float& qz) const {
    qx = q[3 * f];
    qy = q[3 * f + 1];
    qz = q[3 * f + 2];
  }
};

// Asynchronous 4- and 8-byte copies (cp.async.ca), for the exp and dot
// forms' staging of four columns that are not adjacent in wm.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

// Stage targets [m0, m0+n) into `tile` as one cp.async group: the first four
// columns of each row (diff), or (x, y, z, |m|²) from wm's columns 0-2 and 4
// (exp, dot; ld 8).
template <int FORM>
__device__ __forceinline__ void stage_async(float4* tile, const float* tg,
                                            int ld, int m0, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* row = tg + static_cast<size_t>(m0 + k) * ld;
    if (FORM == kDiff) {
      cp_async16(tile + k, row);
    } else {
      cp_async8(&tile[k].x, row);
      cp_async4(&tile[k].z, row + 2);
      cp_async4(&tile[k].w, row + 4);
    }
  }
  cp_async_commit();
}

// Target m's staged float4, read from global memory (the ring route's index
// search): as stage_async lays it out.
template <int FORM>
__device__ __forceinline__ float4 target_row(const float* tg, int ld, int m) {
  const float* row = tg + static_cast<size_t>(m) * ld;
  if (FORM == kDiff) return *reinterpret_cast<const float4*>(row);
  return make_float4(row[0], row[1], row[2], row[4]);
}

// One (query, target) value of the form, from the query's registers (q for
// diff; -2q and |q|² = qn for exp and dot) and the staged target w.  Its
// minimum over the targets is d2 (diff, dot) or d2 - |q|² (exp).
template <int FORM>
__device__ __forceinline__ float pair_d2(float4 w, float qx, float qy, float qz, float qn) {
  if (FORM == kDiff) return dist2(w, qx, qy, qz);
  if (FORM == kExp) return ffma(qz, w.z, ffma(qy, w.y, ffma(qx, w.x, w.w)));
  return fadd(fadd(ffma(qz, w.z, ffma(qy, w.y, fmul(w.x, qx))), qn), w.w);
}

// Walk `len` staged targets t[0..len) (global indices g0...) for QR queries.
// IDX: best[r] is the running minimum and bch[r] the first index of the
// earliest chunk of 8 that reached it; else only the minimum.
template <int QR, bool IDX, int FORM>
__device__ __forceinline__ void scan(const float4* t, int len, int g0,
                                     const float (&qx)[QR], const float (&qy)[QR],
                                     const float (&qz)[QR], const float (&qn)[QR],
                                     float (&best)[QR], int (&bch)[QR]) {
  for (int k = 0; k < len; k += kChunk) {
    float4 w[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) w[u] = t[k + u];
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      if (IDX) {
        float c = pair_d2<FORM>(w[0], qx[r], qy[r], qz[r], qn[r]);
#pragma unroll
        for (int u = 1; u < kChunk; ++u)
          c = fminf(c, pair_d2<FORM>(w[u], qx[r], qy[r], qz[r], qn[r]));
        if (c < best[r]) {
          best[r] = c;
          bch[r] = g0 + k;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          best[r] = fminf(best[r], pair_d2<FORM>(w[u], qx[r], qy[r], qz[r], qn[r]));
      }
    }
  }
}

// The first target of chunk c whose form value is exactly `best` (the
// minimum the scan took, before exp's |q|² is added); `row(m)` gives target
// m's staged float4.  0 when no chunk was taken (every value NaN or +inf: no
// strict improvement over +inf).
template <int FORM, class Row>
__device__ __forceinline__ int first_at(const Row& row, int c, float best, float qx,
                                        float qy, float qz, float qn) {
  if (c < 0) return 0;
  float4 w[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) w[u] = row(c + u);
  int hit = c;  // the chunk's minimum is one of its values
#pragma unroll
  for (int u = kChunk - 1; u >= 0; --u)
    if (pair_d2<FORM>(w[u], qx, qy, qz, qn) == best) hit = c + u;
  return hit;
}

// One CTA of any of the kernels (see the header).  `tile_m` = Mp when the
// targets stay resident, else kRingTile; `S` target splits divide 8;
// every tile holds a multiple of 8·S targets.
template <int QR, bool IDX, int FORM, class Src>
__device__ __forceinline__ void min_d2_body(const Src& src, long long nq,
                                            const float* __restrict__ tg, int ld,
                                            int Mp, int tile_m, int S, int Nt,
                                            float* __restrict__ d2,
                                            int* __restrict__ idx) {
  extern __shared__ float4 nn_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = warp % S, wq = warp / S;
  const int per_item = (kNnWarps / S) * 32 * QR;
  const long long n_items = (nq + per_item - 1) / per_item;
  const int nt = (Mp + tile_m - 1) / tile_m;
  float4* buf[2] = {nn_smem, nn_smem + tile_m};
  float* red_d = reinterpret_cast<float*>(nn_smem + (nt == 1 ? 1 : 2) * tile_m);
  int* red_i = reinterpret_cast<int*>(red_d + kNnThreads * QR);
  // target rows for the index search: resident in shared memory, else global
  const auto row = [&](int m) -> float4 {
    return nt == 1 ? buf[0][m] : target_row<FORM>(tg, ld, m);
  };
  bool staged = nt != 1;
  if (!staged) stage_async<FORM>(buf[0], tg, ld, 0, Mp);  // awaited after the first queries load
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long f0 = item * per_item + wq * 32 * QR + lane;
    float qx[QR], qy[QR], qz[QR], qn[QR], best[QR];
    int bch[QR], bi[QR];
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      qx[r] = qy[r] = qz[r] = qn[r] = 0.f;
      if (f0 + 32 * r < nq) src.template load<FORM>(f0 + 32 * r, qx[r], qy[r], qz[r]);
      if (FORM != kDiff) {  // -2q and |q|², as XLA contracts |q|²
        qn[r] = dot3c(qx[r], qy[r], qz[r], qx[r], qy[r], qz[r]);
        qx[r] = fmul(-2.f, qx[r]);
        qy[r] = fmul(-2.f, qy[r]);
        qz[r] = fmul(-2.f, qz[r]);
      }
      best[r] = finf();
      bch[r] = -1;
    }
    if (!staged) {
      cp_async_wait<0>();
      __syncthreads();
      staged = true;
    }
    if (nt == 1) {
      const int len = Mp / S;
      scan<QR, IDX, FORM>(buf[0] + s * len, len, s * len, qx, qy, qz, qn, best, bch);
    } else {
      stage_async<FORM>(buf[0], tg, ld, 0, tile_m);
      for (int j = 0; j < nt; ++j) {
        const int m0 = j * tile_m, n = min(tile_m, Mp - m0);
        if (j + 1 < nt) {
          stage_async<FORM>(buf[(j + 1) & 1], tg, ld, m0 + tile_m, min(tile_m, Mp - m0 - tile_m));
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int len = n / S;
        scan<QR, IDX, FORM>(buf[j & 1] + s * len, len, m0 + s * len, qx, qy, qz, qn, best, bch);
        __syncthreads();  // the buffer is restaged next
      }
    }
#pragma unroll
    for (int r = 0; r < QR; ++r)
      bi[r] = IDX ? first_at<FORM>(row, bch[r], best[r], qx[r], qy[r], qz[r], qn[r]) : 0;
    if (S > 1) {  // merge the splits in order: lower (d2, index) wins
      const int slot = wq * 32 * QR + lane;
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        red_d[s * per_item + slot + 32 * r] = best[r];
        red_i[s * per_item + slot + 32 * r] = bi[r];
      }
      __syncthreads();
      if (s == 0) {
        for (int o = 1; o < S; ++o) {
#pragma unroll
          for (int r = 0; r < QR; ++r) {
            const float d = red_d[o * per_item + slot + 32 * r];
            const int i = red_i[o * per_item + slot + 32 * r];
            if (d < best[r] || (d == best[r] && i < bi[r])) {
              best[r] = d;
              bi[r] = i;
            }
          }
        }
      }
      __syncthreads();  // red is rewritten by the next item
    }
    if (s == 0) {
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        const long long f = f0 + 32 * r;
        if (f >= nq) continue;
        if (Src::kNearest) {  // best is the winner's distance, unless clamped or not finite
          const int i = min(bi[r], Nt - 1);
          d2[f] = i == bi[r] && best[r] < finf() ? best[r]
                                                 : dist2(row(i), qx[r], qy[r], qz[r]);
          idx[f] = i;
        } else {
          d2[f] = fmaxf(FORM == kExp ? fadd(best[r], qn[r]) : best[r], 0.f);
          if (IDX) idx[f] = bi[r];
        }
      }
    }
  }
}

template <int QR, bool IDX, int FORM>
__global__ void __launch_bounds__(kNnThreads, 2)
min_d2_nodes_kernel(NodeQueries src, long long nq, const float* __restrict__ wm,
                    int Mp, int tile_m, int S, float* __restrict__ d2,
                    int* __restrict__ idx) {
  min_d2_body<QR, IDX, FORM>(src, nq, wm, 8, Mp, tile_m, S, Mp, d2, idx);
}

template <int QR>
__global__ void __launch_bounds__(kNnThreads, 2)
nn_query_kernel(PointQueries src, long long nq, const float* __restrict__ t4,
                int Mp, int tile_m, int S, int Nt, float* __restrict__ d2,
                int* __restrict__ idx) {
  min_d2_body<QR, true, kDiff>(src, nq, t4, 4, Mp, tile_m, S, Nt, d2, idx);
}

// Shared memory, tile and persistent grid of a launch over nq queries.
struct Plan {
  int grid = 0, tile_m = 0;
  size_t smem = 0;
};

template <typename Kernel>
cudaError_t plan(Kernel kernel, long long nq, int Mp, int S, int QR, Plan& p) {
  const bool resident = Mp <= kResidentMax;
  p.tile_m = resident ? Mp : kRingTile;
  p.smem = (resident ? 1 : 2) * static_cast<size_t>(p.tile_m) * sizeof(float4) +
           (S > 1 ? static_cast<size_t>(kNnThreads) * QR * 8 : 0);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p.smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kNnThreads, p.smem);
  if (err != cudaSuccess) return err;
  const long long per_item = (kNnWarps / S) * 32 * QR;
  const long long items = (nq + per_item - 1) / per_item;
  p.grid = static_cast<int>(std::min(items, static_cast<long long>(sms) * std::max(occ, 1)));
  return cudaSuccess;
}

template <int QR, bool IDX, int FORM>
int launch_nodes(const float* params, int B, const float* srcT, int Np, const float* wm,
                 int Mp, int splits, float* d2, int* idx, cudaStream_t st) {
  const long long nq = static_cast<long long>(B) * Np;
  Plan p;
  const cudaError_t err = plan(min_d2_nodes_kernel<QR, IDX, FORM>, nq, Mp, splits, QR, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  min_d2_nodes_kernel<QR, IDX, FORM><<<p.grid, kNnThreads, p.smem, st>>>(
      NodeQueries{params, srcT, Np}, nq, wm, Mp, p.tile_m, splits, d2, idx);
  return static_cast<int>(cudaGetLastError());
}

template <int FORM>
int launch_nodes_form(const float* params, int B, const float* srcT, int Np, const float* wm,
                      int Mp, int splits, int qr, float* d2, int* idx, cudaStream_t st) {
  if (idx == nullptr) {
    if (qr != kK4Qr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_nodes<kK4Qr, false, FORM>(params, B, srcT, Np, wm, Mp, splits, d2, idx, st);
  }
  switch (qr) {
    case 1: return launch_nodes<1, true, FORM>(params, B, srcT, Np, wm, Mp, splits, d2, idx, st);
    case 4: return launch_nodes<4, true, FORM>(params, B, srcT, Np, wm, Mp, splits, d2, idx, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace goicp

// K4 (idx null) and K1 over node poses (idx non-null): d2 [B, Np], and
// idx [B, Np], for B node poses in the form `form` (kDiff, kExp, kDot),
// with `splits` target splits (1, 2, 4 or 8) and `qr` queries per thread
// (4 without idx; 1 or 4 with it); Mp a multiple of 64.
extern "C" int goicp_nn_min_d2(const float* params, int B, const float* srcT,
                               int Np, const float* wm, int Mp, int form,
                               int splits, int qr, float* d2, int* idx,
                               void* stream) {
  using namespace goicp;
  const bool split_ok = splits == 1 || splits == 2 || splits == 4 || splits == 8;
  if (B <= 0 || Np <= 0 || Mp <= 0 || Mp % 64 != 0 || !split_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kDiff:
      return launch_nodes_form<kDiff>(params, B, srcT, Np, wm, Mp, splits, qr, d2, idx, st);
    case kExp:
      return launch_nodes_form<kExp>(params, B, srcT, Np, wm, Mp, splits, qr, d2, idx, st);
    case kDot:
      return launch_nodes_form<kDot>(params, B, srcT, Np, wm, Mp, splits, qr, d2, idx, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int QR>
static int launch_nn_query(const float* q, int Q, const float* t4, int Mp, int Nt,
                           int splits, float* d2, int* idx, cudaStream_t st) {
  using namespace goicp;
  Plan p;
  const cudaError_t err = plan(nn_query_kernel<QR>, Q, Mp, splits, QR, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_query_kernel<QR><<<p.grid, kNnThreads, p.smem, st>>>(
      PointQueries{q}, Q, t4, Mp, p.tile_m, splits, Nt, d2, idx);
  return static_cast<int>(cudaGetLastError());
}

// K1: d2 [Q] and idx [Q] for the points q [Q, 3] against targets t4
// [Mp, 4] (Nt real ones, Mp a multiple of 64), with `splits` target splits
// (1, 2, 4 or 8) and `qr` queries per thread (1 or 4).
extern "C" int goicp_nn_query(const float* q, int Q, const float* t4, int Mp,
                              int Nt, int splits, int qr, float* d2, int* idx,
                              void* stream) {
  const bool split_ok = splits == 1 || splits == 2 || splits == 4 || splits == 8;
  if (Q <= 0 || Nt <= 0 || Nt > Mp || Mp % 64 != 0 || !split_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (qr) {
    case 1: return launch_nn_query<1>(q, Q, t4, Mp, Nt, splits, d2, idx, st);
    case 4: return launch_nn_query<4>(q, Q, t4, Mp, Nt, splits, d2, idx, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
