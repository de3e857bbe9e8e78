// Fused descriptor matcher for Hopper (sm_90a): scores, spatial gate,
// validity mask, per-row top-2 and per-column argmax in one launch.
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
// What bounds it on the card: 2*Q*R*D flops against reading (Q + R)*D*4
// bytes. At the keyframe relocalization shape (512 x 32,768 x 128) that is
// 4.3 GFLOP against 17 MB, 64 us at the fp32 (non-tensor-core) peak, so the
// kernel is bound by FMA issue; at the tracking shape (512 x 256) the work
// is 0.5 us and launch latency and one CTA's serial work bound it. The
// first design (one 32 x 64 tile per CTA, a thread 1 row x 8 columns, and a
// second merge kernel) read 9 float4 from shared memory per 32 FMAs and
// reached 13% of the fp32 peak (0.487 ms at 512 x 32,768, NVIDIA H100 80GB
// HBM3, 700 W). This one:
//   - a CTA scores a 64-query block against its chunk of the reference in
//     64 x 128 tiles; each of its 256 threads holds a 4-row x 8-column
//     register tile, so 12 float4 shared reads feed 128 FMAs;
//   - the query block and the reference tile are staged 32 deep with
//     cp.async into a two-stage ring, so the next stage loads while this
//     one is scored;
//   - the (Q, R) score block never reaches global memory: each tile is
//     reduced at once into per-row top-2 registers and, with `mutual`, into
//     per-(query block, column) partials;
//   - one launch: each CTA writes its partials and takes a ticket on its
//     query block's counter (and, with `mutual`, its chunk's); the CTA that
//     arrives last merges that block's rows over the chunks, or that
//     chunk's columns over the query blocks, and resets the counter to 0 for
//     the next call. Merges combine (value, index) pairs by value and then
//     smaller index, so the result does not depend on the order the CTAs
//     ran in.
//
// Numerics: each dot product is a sequential fp32 FMA chain over D in
// increasing k (no tensor cores, no TF32), as in the first design, so the
// scores are bitwise the same. The file is built with -fmad=false, so the
// FMA is written out as __fmaf_rn; the gate distance dx*dx + dy*dy is
// rounded once per operation, like the plain torch version, so decisions on
// the gate boundary agree. gate2 is the float32 that torch compares against.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3c, device
// time; PERF.md has the runs): about 0.16 ms at 512 x 32,768, some 40% of
// the fp32 peak (the first design: 0.487 ms), and about 0.02 ms at
// 512 x 256 gated. The FMA loop holds it there: the same loop fed from
// registers, with no shared-memory read, ran no faster, and neither did
// 8 x 8 tiles, a deeper ring or more CTAs per SM.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int QB = 64;          // query rows per CTA
constexpr int TR = 128;         // reference rows per tile
constexpr int KC = 32;          // descriptor depth per stage
constexpr int LDK = KC + 4;     // staged row stride: 16-byte rows, no bank conflicts
constexpr int THREADS = 256;    // 16 row lanes x 16 column lanes
constexpr int TY = THREADS / 16;  // row lanes; a thread holds rows ty + TY i
constexpr int RT = QB / TY;       // rows per thread
constexpr int NSTAGE = 2;
constexpr int STAGE = (QB + TR) * LDK;   // floats per stage
constexpr size_t SMEM = sizeof(float) * NSTAGE * STAGE;
constexpr float NEG = -1e9f;

struct Top2 {
  float v1;
  int i1;
  float v2;
};

// A thread visits its columns in increasing order: a later equal value does
// not take the lead, it only raises v2. Written without branches: the
// lanes of a warp disagree here at nearly every column.
__device__ __forceinline__ void push(Top2& t, float v, int c) {
  const bool lead = v > t.v1;
  t.v2 = lead ? t.v1 : fmaxf(t.v2, v);
  t.i1 = lead ? c : t.i1;
  t.v1 = lead ? v : t.v1;
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

__device__ __forceinline__ Top2 shfl_xor(Top2 t, int off) {
  return Top2{__shfl_xor_sync(0xffffffffu, t.v1, off), __shfl_xor_sync(0xffffffffu, t.i1, off),
              __shfl_xor_sync(0xffffffffu, t.v2, off)};
}

// cp.async of 16 (or 4) bytes; a false `ok` writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 1));
}

// Stage depth k0..k0+KC of the query block and of reference tile c0; depth
// past D and rows past the range are zeros, which add exact zeros to the
// FMA chain. VEC: D % 4 == 0 and both bases 16-byte aligned, so every
// 16-byte copy is aligned.
template <bool VEC>
__device__ __forceinline__ void load_stage(float* st, const float* dq, const float* dr,
                                           int q0, int q, int c0, int c_end, int k0, int d) {
  float* sq = st;
  float* sr = st + QB * LDK;
  if (VEC) {
    for (int e = threadIdx.x; e < QB * KC / 4; e += THREADS) {
      const int rr = e / (KC / 4), kk = 4 * (e % (KC / 4)), gq = q0 + rr, gk = k0 + kk;
      const bool ok = gq < q && gk < d;
      cp_async16(sq + rr * LDK + kk, ok ? dq + (size_t)gq * d + gk : dq, ok);
    }
    for (int e = threadIdx.x; e < TR * KC / 4; e += THREADS) {
      const int rr = e / (KC / 4), kk = 4 * (e % (KC / 4)), gc = c0 + rr, gk = k0 + kk;
      const bool ok = gc < c_end && gk < d;
      cp_async16(sr + rr * LDK + kk, ok ? dr + (size_t)gc * d + gk : dr, ok);
    }
  } else {
    for (int e = threadIdx.x; e < QB * KC; e += THREADS) {
      const int rr = e / KC, kk = e % KC, gq = q0 + rr, gk = k0 + kk;
      const bool ok = gq < q && gk < d;
      cp_async4(sq + rr * LDK + kk, ok ? dq + (size_t)gq * d + gk : dq, ok);
    }
    for (int e = threadIdx.x; e < TR * KC; e += THREADS) {
      const int rr = e / KC, kk = e % KC, gc = c0 + rr, gk = k0 + kk;
      const bool ok = gc < c_end && gk < d;
      cp_async4(sr + rr * LDK + kk, ok ? dr + (size_t)gc * d + gk : dr, ok);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2) match_kernel(
    const float* __restrict__ dq, const float* __restrict__ dr,
    const unsigned char* __restrict__ qv, const unsigned char* __restrict__ rv,
    const float* __restrict__ xq, const float* __restrict__ xr, float gate2,
    int gated, int q, int r, int d, int chunk, int mutual,
    float* row_v1, float* row_v2, int* row_i1, float* col_v, int* col_r,
    int* counters, int* __restrict__ i1, float* __restrict__ v1,
    float* __restrict__ v2, int* __restrict__ col_best) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  __shared__ float s_cv[TY][TR];   // per (row lane, column) column best
  __shared__ int s_cr[TY][TR];
  __shared__ int s_last_q, s_last_c;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qb = blockIdx.x, ch = blockIdx.y;
  const int n_qb = gridDim.x, n_chunks = gridDim.y;
  const int q0 = qb * QB;
  const int c_begin = ch * chunk, c_end = min(r, c_begin + chunk);
  const int n_kc = (d + KC - 1) / KC;
  const int n_steps = (c_end - c_begin + TR - 1) / TR * n_kc;

  // this thread's rows q0 + ty + TY i and columns tx + 16 j of each tile;
  // bit i of q_ok: row i is in range and valid
  unsigned q_ok = 0;
  Top2 best[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi < q && qv[qi] != 0) q_ok |= 1u << i;
    best[i] = Top2{-CUDART_INF_F, INT_MAX, -CUDART_INF_F};
  }
  const int q_rows = min(RT, (q - q0 - ty + TY - 1) / TY);   // rows i < q_rows are in range
  float acc[RT][8];

  // step s: depth chunk s % n_kc of tile s / n_kc, in ring slot s % NSTAGE
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_steps)
      load_stage<VEC>(ring + s * STAGE, dq, dr, q0, q, c_begin + s / n_kc * TR, c_end,
                      s % n_kc * KC, d);
    cp_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    const int sp = s + NSTAGE - 1;
    if (sp < n_steps)
      load_stage<VEC>(ring + sp % NSTAGE * STAGE, dq, dr, q0, q, c_begin + sp / n_kc * TR,
                      c_end, sp % n_kc * KC, d);
    cp_commit();
    cp_wait_prev();
    __syncthreads();

    const int kc = s % n_kc;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* sq = ring + s % NSTAGE * STAGE;
    const float* sr = sq + QB * LDK;
#pragma unroll 2
    for (int kk = 0; kk < KC; kk += 4) {
      float4 a[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        a[i] = *reinterpret_cast<const float4*>(sq + (ty + TY * i) * LDK + kk);
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(sr + (tx + 16 * j) * LDK + kk);
      // depth k, k+1, k+2, k+3 in turn, each over the whole register tile:
      // 32 independent FMAs at a time, every dot product still in k order
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i].w, b[j].w, acc[i][j]);
    }

    if (kc == n_kc - 1) {
      // the tile is scored: gate, mask, and reduce it at once
      const int c0 = c_begin + s / n_kc * TR;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = tx + 16 * j, c = c0 + cl;
        const bool c_in = c < c_end;
        const bool c_ok = c_in && rv[c] != 0;
        float cx = 0.f, cy = 0.f;
        if (gated && c_in) {
          cx = xr[2 * c];
          cy = xr[2 * c + 1];
        }
        float cbv = -CUDART_INF_F;
        int cbr = INT_MAX;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int qi = q0 + ty + TY * i;
          bool keep = (q_ok >> i & 1u) && c_ok;
          if (gated && c_in && i < q_rows) {
            const float dx = __fsub_rn(xq[2 * qi], cx);
            const float dy = __fsub_rn(xq[2 * qi + 1], cy);
            const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
            keep = keep && d2 <= gate2;
          }
          const float sc = keep ? acc[i][j] : NEG;
          if (i < q_rows && c_in) {
            push(best[i], sc, c);
            if (mutual && sc > cbv) {   // rows visited in increasing order
              cbv = sc;
              cbr = qi;
            }
          }
        }
        if (mutual) {
          s_cv[ty][cl] = cbv;
          s_cr[ty][cl] = cbr;
        }
      }
      if (mutual) {
        __syncthreads();
        for (int cl = tid; cl < TR; cl += THREADS) {
          if (c0 + cl >= c_end) break;
          float bv = -CUDART_INF_F;
          int br = INT_MAX;
          for (int y = 0; y < TY; ++y) {
            const float v = s_cv[y][tid];
            const int rr = s_cr[y][tid];
            if (v > bv || (v == bv && rr < br)) {
              bv = v;
              br = rr;
            }
          }
          col_v[(size_t)qb * r + c0 + tid] = bv;
          col_r[(size_t)qb * r + c0 + tid] = br;
        }
      }
    }
    __syncthreads();   // ring slot s % NSTAGE (and s_cv) is free again
  }

  // the 16 column lanes of a row are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) best[i] = merge(best[i], shfl_xor(best[i], off));
    if (tx == 0 && i < q_rows) {
      const size_t o = (size_t)ch * q + q0 + ty + TY * i;
      row_v1[o] = best[i].v1;
      row_v2[o] = best[i].v2;
      row_i1[o] = best[i].i1;
    }
  }

  // tickets: the last CTA of a query block merges its rows, the last CTA of
  // a chunk its columns
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last_q = atomicAdd(&counters[qb], 1) == n_chunks - 1;
    s_last_c = mutual ? atomicAdd(&counters[n_qb + ch], 1) == n_qb - 1 : 0;
  }
  __syncthreads();
  if (s_last_q) {
    __threadfence();
    // THREADS / QB threads a row, each over every so many chunks, then
    // combined
    constexpr int TPR = THREADS / QB;
    const int t = q0 + tid / TPR, part = tid % TPR;
    Top2 b{-CUDART_INF_F, INT_MAX, -CUDART_INF_F};
    if (t < q) {
#pragma unroll 4
      for (int c2 = part; c2 < n_chunks; c2 += TPR) {
        const size_t o = (size_t)c2 * q + t;
        b = merge(b, Top2{__ldcg(row_v1 + o), __ldcg(row_i1 + o), __ldcg(row_v2 + o)});
      }
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) b = merge(b, shfl_xor(b, off));
    if (part == 0 && t < q) {
      i1[t] = b.i1 == INT_MAX ? 0 : b.i1;
      v1[t] = b.v1;
      // the plain version masks column i1 with -1e9, so its v2 is never
      // below that, also when R == 1
      v2[t] = fmaxf(b.v2, NEG);
    }
    if (tid == 0) counters[qb] = 0;
  }
  if (s_last_c) {
    __threadfence();
    for (int c = c_begin + tid; c < c_end; c += THREADS) {
      float bv = -CUDART_INF_F;
      int br = 0;
#pragma unroll 8
      for (int b2 = 0; b2 < n_qb; ++b2) {   // blocks in row order: first row on ties
        const float v = __ldcg(col_v + (size_t)b2 * r + c);
        const int rr = __ldcg(col_r + (size_t)b2 * r + c);
        if (v > bv) {
          bv = v;
          br = rr;
        }
      }
      col_best[c] = br;
    }
    if (tid == 0) counters[n_qb + ch] = 0;
  }
}

template <bool VEC>
int launch(dim3 grid, cudaStream_t s, const float* dq, const float* dr,
           const unsigned char* qv, const unsigned char* rv, const float* xq, const float* xr,
           float gate2, int gated, int q, int r, int d, int chunk, int mutual, float* row_v1,
           float* row_v2, int* row_i1, float* col_v, int* col_r, int* counters, int* i1,
           float* v1, float* v2, int* col_best) {
  static int ready_device = -1;   // the shared-memory opt-in, set once per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (ready_device != device) {
    err = cudaFuncSetAttribute(match_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(match_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    ready_device = device;
  }
  match_kernel<VEC><<<grid, THREADS, SMEM, s>>>(dq, dr, qv, rv, xq, xr, gate2, gated, q, r, d,
                                                chunk, mutual, row_v1, row_v2, row_i1, col_v,
                                                col_r, counters, i1, v1, v2, col_best);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch (from the caller, reused across calls on one stream): row_f holds
// 2 * n_chunks * q floats (v1 partials, then v2 partials), row_i n_chunks * q
// ints; with `mutual`, col_f and col_i hold ceil(q / 64) * r each (otherwise
// they, xq/xr when not gated, and col_best may be null). counters holds
// ceil(q / 64) + n_chunks ints that are 0 on entry, and are 0 again when
// the kernel ends. n_chunks = ceil(r / chunk); chunk is a multiple of 128.
extern "C" int ptz_match(const void* dq, const void* dr, const void* qv,
                         const void* rv, const void* xq, const void* xr,
                         float gate2, int gated, int q, int r, int d,
                         int mutual, int chunk, void* row_f, void* row_i,
                         void* col_f, void* col_i, void* counters, void* i1, void* v1,
                         void* v2, void* col_best, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (q <= 0) return (int)cudaSuccess;
  if (r <= 0 || d <= 0 || chunk <= 0 || chunk % TR != 0 || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((q + QB - 1) / QB, (r + chunk - 1) / chunk);
  float* rv1 = (float*)row_f;
  float* rv2 = rv1 + (size_t)grid.y * q;
  const bool vec = d % 4 == 0 && ((uintptr_t)dq | (uintptr_t)dr) % 16 == 0;
  const auto go = vec ? launch<true> : launch<false>;
  return go(grid, (cudaStream_t)stream, (const float*)dq, (const float*)dr,
            (const unsigned char*)qv, (const unsigned char*)rv, (const float*)xq,
            (const float*)xr, gate2, gated, q, r, d, chunk, mutual, rv1, rv2, (int*)row_i,
            (float*)col_f, (int*)col_i, (int*)counters, (int*)i1, (float*)v1, (float*)v2,
            (int*)col_best);
}
