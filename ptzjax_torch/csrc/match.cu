// Fused descriptor matcher for Hopper (sm_90a): scores, spatial gate,
// validity mask, per-row top-2 and per-column argmax in one pass.
//
// Replaces the TPU kernel ptzjax/kernels/match.py:match_pallas. For unit
// descriptors d_query (Q, D) and d_ref (R, D) it computes, per query row,
// i1 (argmax, first index on ties), v1 (the row max) and v2 (the row max
// with only column i1 masked, so a tied maximum gives v2 == v1), and, with
// `mutual`, per reference column col_best (argmax over rows, first row on
// ties). A score is -1e9 where either row is invalid or, when gated, where
// the squared pixel distance exceeds gate2. The decisions (ratio test,
// score floor, mutual check) stay outside, in torch, on these O(Q + R)
// vectors, as the reference keeps them outside its kernel.
//
// What bounds it on the card: 2*Q*R*D flops against reading R*D*4 bytes of
// reference descriptors. At the keyframe relocalization shape (512 x 32,768
// x 128) that is 4.3 GFLOP against 16 MiB, so the kernel is bound by fp32
// FMA throughput and shared-memory bandwidth; at the tracking shape (512 x 256)
// it is bound by launch latency. The (Q, R) score block never reaches
// global memory: a CTA holds a 32 x 64 tile of it in shared memory, reduces
// it at once and keeps only per-row (v1, i1, v2) partials in registers and
// per-(query block, column) partials for the column argmax.
//
// The TPU kernel carried a running column max across its sequential grid.
// Hopper's CTAs run in no order, so the work is split into a grid of
// (query block of 32 rows) x (reference chunk): each CTA writes its own
// partials, and a second small kernel merges the row partials in chunk
// order and the column partials in block order, with the tie rules above.
// There are no atomics, so the result does not depend on scheduling.
//
// Numerics: the dot product is a sequential fp32 FMA chain over D (no
// tensor cores, no TF32). The file is built with -fmad=false, so the FMA is
// written out as __fmaf_rn; the gate distance dx*dx + dy*dy is rounded once
// per operation, like the plain torch version, so decisions on the gate
// boundary agree. gate2 is the float32 that torch compares against.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int QB = 32;          // query rows per CTA
constexpr int TR = 64;          // reference rows per tile
constexpr int KC = 32;          // descriptor depth staged per step
constexpr int LDK = KC + 4;     // staged row stride: 16-byte rows, no bank conflicts
constexpr int THREADS = 256;    // 32 rows x 8 column lanes
constexpr float NEG = -1e9f;

struct Top2 {
  float v1;
  int i1;
  float v2;
};

// A thread visits its columns in increasing order: a later equal value does
// not take the lead, it only raises v2.
__device__ __forceinline__ void push(Top2& t, float v, int c) {
  if (v > t.v1) {
    t.v2 = t.v1;
    t.v1 = v;
    t.i1 = c;
  } else if (v > t.v2) {
    t.v2 = v;
  }
}

// Larger value wins, an equal value goes to the smaller index; the loser's
// best is a candidate for the second place.
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool a_wins = a.v1 > b.v1 || (a.v1 == b.v1 && a.i1 < b.i1);
  Top2 r;
  r.v1 = a_wins ? a.v1 : b.v1;
  r.i1 = a_wins ? a.i1 : b.i1;
  r.v2 = fmaxf(fmaxf(a.v2, b.v2), a_wins ? b.v1 : a.v1);
  return r;
}

__global__ void __launch_bounds__(THREADS) match_tiles(
    const float* __restrict__ dq, const float* __restrict__ dr,
    const unsigned char* __restrict__ qv, const unsigned char* __restrict__ rv,
    const float* __restrict__ xq, const float* __restrict__ xr, float gate2,
    int gated, int q, int r, int d, int chunk, int mutual,
    float* __restrict__ row_v1, float* __restrict__ row_v2,
    int* __restrict__ row_i1, float* __restrict__ col_v,
    int* __restrict__ col_r) {
  __shared__ __align__(16) float sq[QB * LDK];
  __shared__ __align__(16) float sr[TR * LDK];
  __shared__ float ss[QB][TR + 1];

  const int tid = threadIdx.x;
  const int row = tid >> 3, lane8 = tid & 7;
  const int qb = blockIdx.x, ch = blockIdx.y;
  const int q0 = qb * QB;
  const int c_begin = ch * chunk;
  const int c_end = min(r, c_begin + chunk);
  const int qi = q0 + row;
  const bool q_in = qi < q;
  const bool q_ok = q_in && qv[qi] != 0;
  float qx = 0.f, qy = 0.f;
  if (gated && q_in) {
    qx = xq[2 * qi];
    qy = xq[2 * qi + 1];
  }
  Top2 best{-CUDART_INF_F, INT_MAX, -CUDART_INF_F};

  for (int c0 = c_begin; c0 < c_end; c0 += TR) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += KC) {
      // stage the query block and the reference tile; depth past D is zero,
      // which adds exact zeros to the FMA chain
      for (int e = tid; e < QB * KC; e += THREADS) {
        const int rr = e / KC, kk = e % KC, gq = q0 + rr, gk = k0 + kk;
        sq[rr * LDK + kk] = (gq < q && gk < d) ? dq[(size_t)gq * d + gk] : 0.f;
      }
      for (int e = tid; e < TR * KC; e += THREADS) {
        const int rr = e / KC, kk = e % KC, gc = c0 + rr, gk = k0 + kk;
        sr[rr * LDK + kk] = (gc < c_end && gk < d) ? dr[(size_t)gc * d + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < KC; kk += 4) {
        const float4 a = *reinterpret_cast<const float4*>(&sq[row * LDK + kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b =
              *reinterpret_cast<const float4*>(&sr[(lane8 + 8 * j) * LDK + kk]);
          acc[j] = __fmaf_rn(a.x, b.x, acc[j]);
          acc[j] = __fmaf_rn(a.y, b.y, acc[j]);
          acc[j] = __fmaf_rn(a.z, b.z, acc[j]);
          acc[j] = __fmaf_rn(a.w, b.w, acc[j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = lane8 + 8 * j, c = c0 + cl;
      const bool c_in = c < c_end;
      bool keep = q_ok && c_in && rv[c] != 0;
      if (gated && c_in) {
        const float dx = __fsub_rn(qx, xr[2 * c]);
        const float dy = __fsub_rn(qy, xr[2 * c + 1]);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        keep = keep && d2 <= gate2;
      }
      const float s = keep ? acc[j] : NEG;
      ss[row][cl] = s;
      if (q_in && c_in) push(best, s, c);
    }

    if (mutual) {
      __syncthreads();
      if (tid < TR && c0 + tid < c_end) {
        float bv = -CUDART_INF_F;
        int br = q0;
        const int rows = min(QB, q - q0);
        for (int rr = 0; rr < rows; ++rr) {
          const float s = ss[rr][tid];
          if (s > bv) {
            bv = s;
            br = q0 + rr;
          }
        }
        col_v[(size_t)qb * r + c0 + tid] = bv;
        col_r[(size_t)qb * r + c0 + tid] = br;
      }
      __syncthreads();
    }
  }

  // the 8 lanes of a row are 8 consecutive lanes of one warp
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
    Top2 o;
    o.v1 = __shfl_xor_sync(0xffffffffu, best.v1, off);
    o.i1 = __shfl_xor_sync(0xffffffffu, best.i1, off);
    o.v2 = __shfl_xor_sync(0xffffffffu, best.v2, off);
    best = merge(best, o);
  }
  if (lane8 == 0 && q_in) {
    row_v1[(size_t)ch * q + qi] = best.v1;
    row_v2[(size_t)ch * q + qi] = best.v2;
    row_i1[(size_t)ch * q + qi] = best.i1;
  }
}

__global__ void match_merge(int q, int r, int n_chunks, int n_qb, int mutual,
                            const float* __restrict__ row_v1,
                            const float* __restrict__ row_v2,
                            const int* __restrict__ row_i1,
                            const float* __restrict__ col_v,
                            const int* __restrict__ col_r, int* __restrict__ i1,
                            float* __restrict__ v1, float* __restrict__ v2,
                            int* __restrict__ col_best) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < q) {
    Top2 b{row_v1[t], row_i1[t], row_v2[t]};
    for (int ch = 1; ch < n_chunks; ++ch) {
      const size_t o = (size_t)ch * q + t;
      b = merge(b, Top2{row_v1[o], row_i1[o], row_v2[o]});
    }
    i1[t] = b.i1 == INT_MAX ? 0 : b.i1;
    v1[t] = b.v1;
    // the plain version masks column i1 with -1e9, so its v2 is never below
    // that, also when R == 1
    v2[t] = fmaxf(b.v2, NEG);
  } else if (mutual && t < q + r) {
    const int c = t - q;
    float bv = col_v[c];
    int br = col_r[c];
    for (int b = 1; b < n_qb; ++b) {
      const float v = col_v[(size_t)b * r + c];
      if (v > bv) {
        bv = v;
        br = col_r[(size_t)b * r + c];
      }
    }
    col_best[c] = br;
  }
}

}  // namespace

// Scratch (allocated by the caller): row_f holds 2 * n_chunks * q floats
// (v1 partials, then v2 partials), row_i n_chunks * q ints; with `mutual`,
// col_f and col_i hold ceil(q / 32) * r each (otherwise they, xq/xr when not
// gated, and col_best may be null). n_chunks = ceil(r / chunk); chunk is a
// multiple of 64.
extern "C" int ptz_match(const void* dq, const void* dr, const void* qv,
                         const void* rv, const void* xq, const void* xr,
                         float gate2, int gated, int q, int r, int d,
                         int mutual, int chunk, void* row_f, void* row_i,
                         void* col_f, void* col_i, void* i1, void* v1, void* v2,
                         void* col_best, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (q <= 0) return (int)cudaSuccess;
  if (r <= 0 || d <= 0 || chunk <= 0 || chunk % TR != 0)
    return (int)cudaErrorInvalidValue;
  const int n_qb = (q + QB - 1) / QB;
  const int n_chunks = (r + chunk - 1) / chunk;
  cudaStream_t s = (cudaStream_t)stream;
  float* rv1 = (float*)row_f;
  float* rv2 = rv1 + (size_t)n_chunks * q;
  match_tiles<<<dim3(n_qb, n_chunks), THREADS, 0, s>>>(
      (const float*)dq, (const float*)dr, (const unsigned char*)qv,
      (const unsigned char*)rv, (const float*)xq, (const float*)xr, gate2,
      gated, q, r, d, chunk, mutual, rv1, rv2, (int*)row_i, (float*)col_f,
      (int*)col_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = q + (mutual ? r : 0);
  match_merge<<<(total + 255) / 256, 256, 0, s>>>(
      q, r, n_chunks, n_qb, mutual, rv1, rv2, (const int*)row_i,
      (const float*)col_f, (const int*)col_i, (int*)i1, (float*)v1, (float*)v2,
      (int*)col_best);
  return (int)cudaGetLastError();
}
