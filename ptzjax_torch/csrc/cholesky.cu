// Cholesky factor of one symmetric positive definite fp32 matrix for Hopper
// (sm_90a): L with S = L L^T, in one launch of one CTA.
//
// Replaces the TPU kernel ptzjax/kernels/cholesky_pallas.py:cholesky_pallas
// (its _chol_kernel and _factor_diag_unrolled). It reads only the lower
// triangle of S, writes zeros above the diagonal, takes any n >= 1 (the
// TPU kernel's n % 32 rule was a tiling artifact) and reports `info` as
// torch.linalg.cholesky_ex does: 0, or the 1-based index of the first pivot
// that is not positive (or is NaN). The TPU kernel clamps such a pivot at
// 1e-30 and raises no flag (what follows overflows its block inverse); here
// the factorization stops, and the EKF turns the factor into NaN from
// `info`, so the frame becomes a no-op flagged LOST, as on the plain path.
//
// What bounds it on the card: n^3/3 flops (45 MFLOP at the EKF's n = 512)
// on one SM, behind a chain of n dependent pivots with a CTA barrier around
// each of the n/32 panels. The algorithm is right-looking over 32-wide
// panels:
//   1. one warp factors the 32 x 32 diagonal block, a row per lane in
//      registers, with column t of L passed between lanes by shuffles;
//   2. every thread solves one row of the panel below it by forward
//      substitution against that block (kept in shared memory), on rows
//      staged in shared memory so that global memory is read and written a
//      whole row at a time;
//   3. the panel is staged in shared memory and the trailing lower triangle
//      is updated in global memory (1 MiB at n = 512, resident in L2): a
//      warp holds two panel rows in registers and its lanes walk the
//      columns, four at a time, reading each column's panel row with float4
//      loads. Two rows (64 registers) keep the kernel within 128 registers
//      a thread at 512 threads, with a few bytes of spills (four rows, as
//      4 x 4 tiles, spilled more and ran slower); four columns per lane keep eight read-modify-writes in
//      flight. Shared-memory bandwidth bounds this step: each 128-byte
//      panel row read serves only two rows.
// The TPU kernel inverted the diagonal block with a Neumann product only
// because its matrix unit prefers products to substitution; that is gone.
// It is one launch where cuSOLVER's potrf makes several.

#include <cuda_runtime.h>

namespace {

constexpr int P = 32;            // panel width
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int LD = 36;           // staged row stride: 16-byte rows, no bank conflicts
constexpr int SLOT_ROWS = 768;   // rows of the trailing matrix staged at once

__device__ void stage_panel(float* dst, const float* l, int n, int c0, int r0,
                            int r1) {
  for (int e = threadIdx.x; e < (r1 - r0) * P; e += THREADS) {
    const int rr = e / P, t = e % P;
    dst[rr * LD + t] = l[(size_t)(r0 + rr) * n + c0 + t];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    cholesky_kernel(const float* __restrict__ s, float* __restrict__ l,
                    int* __restrict__ info, int n, int slot_rows,
                    int stage_rows) {
  extern __shared__ float4 smem4[];
  float* const stage = reinterpret_cast<float*>(smem4);
  __shared__ float dblk[P][P + 1];
  __shared__ int fail;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // working copy: the lower triangle of S, zeros above the diagonal
  for (int i = warp; i < n; i += NWARPS)
    for (int j = lane; j < n; j += 32)
      l[(size_t)i * n + j] = j <= i ? s[(size_t)i * n + j] : 0.f;
  if (tid == 0) fail = 0;
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += P) {
    const int w = min(P, n - c0);

    // 1. diagonal block, one warp; lane i holds row i of the block in
    //    registers, and column t of L goes to the lanes by shuffles
    if (warp == 0) {
      float a[P];
#pragma unroll
      for (int j = 0; j < P; ++j)
        a[j] = lane < w && j <= lane ? l[(size_t)(c0 + lane) * n + c0 + j] : 0.f;
      int bad = 0;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        if (t >= w) break;
        const float piv = __shfl_sync(0xffffffffu, a[t], t);
        if (!(piv > 0.f)) {   // uniform: every lane holds the same pivot
          bad = c0 + t + 1;
          break;
        }
        const float dg = sqrtf(piv);
        const float lt = lane == t ? dg : (lane > t ? a[t] / dg : a[t]);
        a[t] = lt;
#pragma unroll
        for (int j = t + 1; j < P; ++j) {
          const float ljt = __shfl_sync(0xffffffffu, lt, j);
          if (lane >= j) a[j] = __fmaf_rn(-lt, ljt, a[j]);
        }
      }
      if (lane == 0) fail = bad;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        dblk[lane][j] = a[j];
        if (lane < w && j <= lane) l[(size_t)(c0 + lane) * n + c0 + j] = a[j];
      }
    }
    __syncthreads();
    if (fail) {
      if (tid == 0) *info = fail;
      return;
    }
    const int m0 = c0 + P;   // first trailing row; only the last panel has w < P
    if (m0 >= n) break;

    // 2. panel below the block: x L_jj^T = a, one row per thread, column by
    //    column (x_t final, then removed from the later columns). Rows are
    //    staged in shared memory so that global memory is read and written
    //    a whole row at a time.
    for (int rs = m0; rs < n; rs += stage_rows) {
      const int re = min(n, rs + stage_rows);
      stage_panel(stage, l, n, c0, rs, re);
      __syncthreads();
      for (int i = rs + tid; i < re; i += THREADS) {
        float4* rv = reinterpret_cast<float4*>(stage + (size_t)(i - rs) * LD);
        // an opaque copy of the block's address: without it the compiler
        // hoists all 528 block reads out of this loop and spills them
        const float* db = &dblk[0][0];
        asm volatile("" : "+l"(db));
        float x[P];
#pragma unroll
        for (int q = 0; q < P / 4; ++q) {
          const float4 v = rv[q];
          x[4 * q] = v.x;
          x[4 * q + 1] = v.y;
          x[4 * q + 2] = v.z;
          x[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int t = 0; t < P; ++t) {
          x[t] = x[t] / db[t * (P + 1) + t];
#pragma unroll
          for (int u = t + 1; u < P; ++u) x[u] = __fmaf_rn(-x[t], db[u * (P + 1) + t], x[u]);
        }
#pragma unroll
        for (int q = 0; q < P / 4; ++q)
          rv[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
      }
      __syncthreads();
      for (int e = tid; e < (re - rs) * P; e += THREADS) {
        const int rr = e / P, t = e % P;
        l[(size_t)(rs + rr) * n + c0 + t] = stage[rr * LD + t];
      }
      __syncthreads();
    }

    // 3. trailing update A[i][j] -= sum_t L[i][c0+t] L[j][c0+t], j <= i,
    //    over pairs of staged row ranges (one pair when n <= slot_rows)
    for (int ib = m0; ib < n; ib += slot_rows) {
      const int ie = min(n, ib + slot_rows);
      for (int jb = m0; jb <= ib; jb += slot_rows) {
        const int je = min(n, jb + slot_rows);
        const float* pi = stage;
        const float* pj = jb == ib ? stage : stage + (size_t)slot_rows * LD;
        stage_panel(stage, l, n, c0, ib, ie);
        if (jb != ib) stage_panel(stage + (size_t)slot_rows * LD, l, n, c0, jb, je);
        __syncthreads();
        // a warp owns 2 consecutive rows, held in registers (row g + 1 past
        // ie reads a stale staged row that is never stored)
        for (int g = ib + 2 * warp; g < ie; g += 2 * NWARPS) {
          float4 r0[P / 4], r1[P / 4];
          const float4* p0 = reinterpret_cast<const float4*>(pi + (size_t)(g - ib) * LD);
          const float4* p1 = reinterpret_cast<const float4*>(pi + (size_t)(g - ib + 1) * LD);
#pragma unroll
          for (int q = 0; q < P / 4; ++q) {
            r0[q] = p0[q];
            r1[q] = p1[q];
          }
          // each lane takes 4 columns, 32 apart; past jend it re-reads the
          // last staged column and stores nothing
          const int jend = min(je, g + 2);
          for (int j0 = jb + lane; j0 < jend; j0 += 4 * 32) {
            float acc0[4], acc1[4], c0v[4], c1v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int j = j0 + 32 * k;
              c0v[k] = j < jend && j <= g ? l[(size_t)g * n + j] : 0.f;
              c1v[k] = j < jend && g + 1 < ie ? l[(size_t)(g + 1) * n + j] : 0.f;
              acc0[k] = 0.f;
              acc1[k] = 0.f;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int j = min(j0 + 32 * k, jend - 1);
              const float4* pr = reinterpret_cast<const float4*>(pj + (size_t)(j - jb) * LD);
#pragma unroll
              for (int q = 0; q < P / 4; ++q) {
                const float4 b = pr[q];
                acc0[k] = __fmaf_rn(r0[q].x, b.x, acc0[k]);
                acc0[k] = __fmaf_rn(r0[q].y, b.y, acc0[k]);
                acc0[k] = __fmaf_rn(r0[q].z, b.z, acc0[k]);
                acc0[k] = __fmaf_rn(r0[q].w, b.w, acc0[k]);
                acc1[k] = __fmaf_rn(r1[q].x, b.x, acc1[k]);
                acc1[k] = __fmaf_rn(r1[q].y, b.y, acc1[k]);
                acc1[k] = __fmaf_rn(r1[q].z, b.z, acc1[k]);
                acc1[k] = __fmaf_rn(r1[q].w, b.w, acc1[k]);
              }
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int j = j0 + 32 * k;
              if (j < jend && j <= g) l[(size_t)g * n + j] = __fsub_rn(c0v[k], acc0[k]);
              if (j < jend && j <= g + 1 && g + 1 < ie)
                l[(size_t)(g + 1) * n + j] = __fsub_rn(c1v[k], acc1[k]);
            }
          }
        }
        __syncthreads();
      }
    }
  }
  if (tid == 0) *info = 0;
}

}  // namespace

extern "C" int ptz_cholesky(const void* s, void* l, void* info, int n,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  // a multiple of 4 rows, so a warp's 4-row strip stays inside its slot
  const int slot_rows = min(SLOT_ROWS, (n + 3) / 4 * 4);
  const int slots = n > slot_rows ? 2 : 1;
  const size_t smem = (size_t)slots * slot_rows * LD * sizeof(float);
  err = cudaFuncSetAttribute(cholesky_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cholesky_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)s, (float*)l, (int*)info, n, slot_rows, slots * slot_rows);
  return (int)cudaGetLastError();
}
