// Cholesky factor of one symmetric positive definite fp32 matrix for Hopper
// (sm_90a): L with S = L L^T, in one launch of one thread-block cluster.
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
// What bounds it on the card: not the n^3/3 flops (45 MFLOP at the EKF's
// n = 512, 0.67 us at the fp32 peak) but latency: n/32 panel steps, each a
// chain of 32 dependent pivots and two cluster barriers with a round trip
// through distributed shared memory after each. The first design ran on one
// CTA with the trailing matrix in L2 and took 0.56 ms at n = 512, 3.2x
// cuSOLVER's cholesky_ex. This one spreads the factor over a cluster of 8
// CTAs on neighbouring SMs:
//   - the 32-row block rows are dealt to the CTAs cyclically, reflected every
//     other round (0..7, then 7..0, ...): with plain b mod 8 the CTA that
//     holds block rows 7 and 15 does 148 of the 680 tile updates at n = 512;
//     reflected, the most any CTA does is 120 (block row 15 alone);
//   - each CTA keeps its block rows in shared memory, and a copy of the
//     current panel column (n x 32), at n <= 512: 203 KB of the 227 KB;
//   - step k: barrier; every CTA copies the factored 32 x 32 diagonal block
//     (with its reciprocal diagonal and a failure flag) from its owner's
//     shared memory, and solves its own block rows below k against it, a
//     row per thread; barrier; every CTA copies the other CTAs' solved panel
//     rows into its panel copy and updates its own trailing rows from it,
//     64 threads per 32 x 32 tile, each a 4 x 4 register tile fed by float4
//     reads (one per 8 FMAs). Copies are pulled by all threads after a
//     barrier: pushing them from the threads that produce them was no
//     faster, nor was factoring the next block between the arrive and the
//     wait of the second barrier;
//   - look-ahead: in the owner of block row k + 1, two warps update that
//     row's diagonal tile first and one of them factors the block for step
//     k + 1 while the other warps finish the update. The factor holds a row
//     per lane in registers, passes column t by shuffles and computes the
//     next pivot ahead on its own lane, so the chain is a shuffle, an rsqrt,
//     a multiply and an FMA per pivot;
//   - where the rows and panel do not fit (n > 512), the same kernel keeps
//     the rows in the output L and one panel copy in a global workspace
//     (read past L1), chosen by the host (kernels/cholesky.py:plan).
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3d, device
// time; PERF.md has the runs): about 0.16 ms at n = 512 against
// cholesky_ex's 0.17 ms, 0.065 against 0.08 ms at n = 256, and 1.5 against
// 0.35 ms at n = 1,024 (global branch): about 10 us a panel step at
// n = 512, where the flops alone would take under 1 us on 8 SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int P = 32;                  // panel width = block-row height
constexpr int CLUSTER = 8;             // CTAs in the cluster (the portable size)
constexpr int THREADS = 512;
constexpr int GROUPS = THREADS / 64;   // trailing-update groups, one tile each
constexpr int LDP_SMEM = 36;           // panel copy row stride: 16-byte rows, no bank conflicts
constexpr int LDP_GLOBAL = 32;
constexpr int NO_CLUSTER = 1000;       // returned when the cluster cannot be resident

// Block row b lives on CTA owner_of(b), in slot b / CLUSTER of that CTA:
// dealt cyclically, reflected every other round (kernels/cholesky.py:plan).
__device__ __forceinline__ int block_of(int cta, int slot) {
  return slot * CLUSTER + (slot % 2 == 0 ? cta : CLUSTER - 1 - cta);
}
__device__ __forceinline__ int owner_of(int b) {
  const int slot = b / CLUSTER, pos = b % CLUSTER;
  return slot % 2 == 0 ? pos : CLUSTER - 1 - pos;
}

// Row stride of the owned rows in shared memory: == 8 (mod 32), so the
// 4 rows x 8 columns a warp touches in the update fall in 32 distinct banks.
__host__ __device__ __forceinline__ int smem_lda(int nb) { return nb * P + 8; }

size_t smem_bytes(int n) {
  const int nb = (n + P - 1) / P, slots = (nb + CLUSTER - 1) / CLUSTER;
  return sizeof(float) * ((size_t)slots * P * smem_lda(nb) + (size_t)nb * P * LDP_SMEM);
}

template <bool SMEM>
__device__ __forceinline__ float* row_ptr(float* srows, float* l, int lda, int n,
                                          int slot, int b, int rr) {
  return SMEM ? srows + (size_t)(slot * P + rr) * lda : l + (size_t)(b * P + rr) * n;
}

template <bool SMEM>
__device__ __forceinline__ float4 ld_panel(const float* p) {
  // in the global branch other SMs wrote the panel: read it past L1
  return SMEM ? *reinterpret_cast<const float4*>(p) : __ldcg(reinterpret_cast<const float4*>(p));
}

// One warp factors the w x w diagonal block whose row `lane` starts at dr
// (column c0 of the matrix): lane i holds row i in registers, column t of L
// reaches the lanes by shuffles, and lane t + 1 computes the next pivot
// ahead of the rest of the column, so the chain is one shuffle, one rsqrt,
// a multiply and an FMA per pivot. Rows past w are the identity, so the
// loop has no branch; after a bad pivot it runs on (the caller discards
// the block by the flag). Writes the factor into the rows, the block
// transposed (dt[t * P + u] = L[u][t]) with its reciprocal diagonal at
// dt[P * P + t], and the flag (0, or the 1-based index of the first pivot
// that is not positive) into *flag.
__device__ __forceinline__ void factor_diag(float* dr, int w, int c0, float* dt, int* flag,
                                            int lane) {
  float a[P];
#pragma unroll
  for (int j = 0; j < P; ++j) a[j] = lane < w ? (j <= lane ? dr[j] : 0.f) : (j == lane ? 1.f : 0.f);
  int bad = 0;
  float rs_lane = 0.f;
  float dnext = a[0];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const float piv = __shfl_sync(0xffffffffu, dnext, t);
    if (bad == 0 && !(piv > 0.f)) bad = c0 + t + 1;   // uniform: one pivot for all lanes
    const float rs = rsqrtf(piv);
    const float lt = lane == t ? piv * rs : (lane > t ? a[t] * rs : a[t]);
    a[t] = lt;
    if (lane == t) rs_lane = rs;
    if (t + 1 < P) dnext = __fmaf_rn(-lt, lt, a[t + 1]);
    // above the diagonal (lane < j) this writes values nobody reads
#pragma unroll
    for (int j = t + 1; j < P; ++j) a[j] = __fmaf_rn(-lt, __shfl_sync(0xffffffffu, lt, j), a[j]);
  }
  if (lane < w) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j <= lane) dr[j] = a[j];
  }
#pragma unroll
  for (int t = 0; t < P; ++t) dt[t * P + lane] = a[t];
  dt[P * P + lane] = rs_lane;
  if (lane == 0) *flag = bad;
}

// A[i][j] -= sum_t L[i][c0+t] L[j][c0+t] for the 32 x 32 tile (block row b,
// block column bj); 64 threads, each rows rq + 8 ii and columns cq + 8 jj.
template <bool SMEM>
__device__ __forceinline__ void update_tile(float* srows, float* l, const float* panel,
                                            int lda, int ldp, int n, int slot, int b,
                                            int bj, int rq, int cq) {
  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
  const float* pr = panel + (size_t)(b * P + rq) * ldp;
  const float* pc = panel + (size_t)(bj * P + cq) * ldp;
#pragma unroll
  for (int t = 0; t < P; t += 4) {
    float4 rv[4], cv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rv[e] = ld_panel<SMEM>(pr + (size_t)8 * e * ldp + t);
      cv[e] = ld_panel<SMEM>(pc + (size_t)8 * e * ldp + t);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        acc[ii][jj] = __fmaf_rn(rv[ii].x, cv[jj].x, acc[ii][jj]);
        acc[ii][jj] = __fmaf_rn(rv[ii].y, cv[jj].y, acc[ii][jj]);
        acc[ii][jj] = __fmaf_rn(rv[ii].z, cv[jj].z, acc[ii][jj]);
        acc[ii][jj] = __fmaf_rn(rv[ii].w, cv[jj].w, acc[ii][jj]);
      }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int rr = rq + 8 * ii, i = b * P + rr;
    if (i >= n) continue;
    float* row = row_ptr<SMEM>(srows, l, lda, n, slot, b, rr);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = bj * P + cq + 8 * jj;
      if (j < n && j <= i) row[j] = __fsub_rn(row[j], acc[ii][jj]);
    }
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS, 1)
    cholesky_cluster(const float* __restrict__ s, float* __restrict__ l,
                     int* __restrict__ info, float* __restrict__ gpanel, int n) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  // dt: the diagonal block this CTA factored last (others copy it from
  // here); dk: the copy of step k's block that the solve reads
  __shared__ __align__(16) float dt[P * P + P];
  __shared__ __align__(16) float dk[P * P + P];
  __shared__ int flag, flag_k;

  const int cta = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = (n + P - 1) / P;
  const int slots = (nb + CLUSTER - 1) / CLUSTER;
  const int lda = SMEM ? smem_lda(nb) : n;
  const int ldp = SMEM ? LDP_SMEM : LDP_GLOBAL;
  float* const srows = reinterpret_cast<float*>(smem4);
  float* const panel = SMEM ? srows + (size_t)slots * P * lda : gpanel;

  // own rows: the lower triangle of S, zeros above the diagonal
  for (int slot = 0; slot < slots; ++slot) {
    const int b = block_of(cta, slot);
    if (b >= nb) break;
    for (int e = tid; e < P * n; e += THREADS) {
      const int rr = e / n, j = e - rr * n, i = b * P + rr;
      if (i < n) row_ptr<SMEM>(srows, l, lda, n, slot, b, rr)[j] = j <= i ? s[(size_t)i * n + j] : 0.f;
    }
  }
  __syncthreads();
  if (cta == 0 && warp == 0)   // CTA 0 owns block row 0
    factor_diag(row_ptr<SMEM>(srows, l, lda, n, 0, 0, lane), min(P, n), 0, dt, &flag, lane);

  for (int k = 0;; ++k) {
    const int c0 = k * P;
    // A: step k's diagonal block is factored (and every CTA runs)
    cluster.sync();
    {
      const int own = owner_of(k);
      const float4* src = reinterpret_cast<const float4*>(cluster.map_shared_rank(dt, own));
      for (int e = tid; e < (P * P + P) / 4; e += THREADS) reinterpret_cast<float4*>(dk)[e] = src[e];
      if (tid == 0) flag_k = *cluster.map_shared_rank(&flag, own);
    }
    __syncthreads();
    if (flag_k) {
      cluster.sync();   // no CTA leaves while another may still read its block
      if (cta == 0 && tid == 0) *info = flag_k;
      return;
    }
    if (c0 + P >= n) break;

    // solve the own block rows below k, X L_kk^T = A, a row per thread, into
    // the own rows and the own rows of the panel copy
    int slot_lo = 0;
    while (slot_lo < slots && block_of(cta, slot_lo) <= k) ++slot_lo;
    for (int e = tid; e < (slots - slot_lo) * P; e += THREADS) {
      const int slot = slot_lo + e / P, rr = e % P, b = block_of(cta, slot), i = b * P + rr;
      if (b >= nb || i >= n) continue;
      float* row = row_ptr<SMEM>(srows, l, lda, n, slot, b, rr) + c0;
      // an opaque copy of the block's address: without it the compiler
      // hoists all the block's reads ahead of the solve and spills them
      const float* db = dk;
      asm volatile("" : "+l"(db));
      float x[P];
#pragma unroll
      for (int t = 0; t < P; ++t) x[t] = row[t];
#pragma unroll
      for (int t = 0; t < P; ++t) {
        x[t] = x[t] * db[P * P + t];
#pragma unroll
        for (int q = (t + 1) / 4; q < P / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(db + t * P)[q];
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4)
            if (4 * q + e4 > t) x[4 * q + e4] = __fmaf_rn(-x[t], vv[e4], x[4 * q + e4]);
        }
      }
      float4* pr = reinterpret_cast<float4*>(panel + (size_t)i * ldp);
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        row[4 * q] = x[4 * q];
        row[4 * q + 1] = x[4 * q + 1];
        row[4 * q + 2] = x[4 * q + 2];
        row[4 * q + 3] = x[4 * q + 3];
        pr[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
      }
    }
    if (!SMEM) __threadfence();
    // B: every CTA's part of the panel is solved
    cluster.sync();
    if (SMEM) {
      // copy the other CTAs' panel rows below k into the own panel copy
      const int r0 = (k + 1) * P;
      for (int e = tid; e < (nb * P - r0) * (P / 4); e += THREADS) {
        const int i = r0 + e / (P / 4), q = e % (P / 4), o = owner_of(i / P);
        if (o == cta) continue;
        reinterpret_cast<float4*>(panel + (size_t)i * ldp)[q] =
            reinterpret_cast<const float4*>(cluster.map_shared_rank(panel, o) + (size_t)i * ldp)[q];
      }
      __syncthreads();
    }

    // trailing update of the own rows. Look-ahead: in the owner of block
    // row k + 1, group 0 updates that row's diagonal tile (its only tile)
    // and its warp 0 factors the block for step k + 1 while the other
    // groups update the rest; elsewhere tile u of the CTA's list (block row
    // by block row, columns k+1..b) goes to group u mod GROUPS.
    {
      const int kn = k + 1;
      const bool ahead = owner_of(kn) == cta;
      const int g = tid >> 6, l64 = tid & 63, rq = l64 >> 3, cq = l64 & 7;
      if (ahead && g == 0) {
        const int slot = kn / CLUSTER;
        update_tile<SMEM>(srows, l, panel, lda, ldp, n, slot, kn, kn, rq, cq);
        asm volatile("bar.sync 1, 64;" ::: "memory");
        if (warp == 0)
          factor_diag(row_ptr<SMEM>(srows, l, lda, n, slot, kn, lane) + kn * P,
                      min(P, n - kn * P), kn * P, dt, &flag, lane);
      } else {
        const int groups = ahead ? GROUPS - 1 : GROUPS;
        int u = ahead ? g - 1 : g;
        for (int slot = slot_lo; slot < slots; ++slot) {
          const int b = block_of(cta, slot);
          if (b >= nb) break;
          if (b == kn && ahead) continue;
          const int cnt = b - k;
          for (; u < cnt; u += groups)
            update_tile<SMEM>(srows, l, panel, lda, ldp, n, slot, b, k + 1 + u, rq, cq);
          u -= cnt;
        }
      }
    }
  }
  cluster.sync();   // no CTA leaves while another may still read its block

  if (SMEM) {
    for (int slot = 0; slot < slots; ++slot) {
      const int b = block_of(cta, slot);
      if (b >= nb) break;
      for (int e = tid; e < P * n; e += THREADS) {
        const int rr = e / n, j = e - rr * n, i = b * P + rr;
        if (i < n) l[(size_t)i * n + j] = j <= i ? row_ptr<SMEM>(srows, l, lda, n, slot, b, rr)[j] : 0.f;
      }
    }
  }
  if (cta == 0 && tid == 0) *info = 0;
}

template <bool SMEM>
int launch(const float* s, float* l, int* info, float* work, int n, int device,
           cudaStream_t stream) {
  const auto kernel = cholesky_cluster<SMEM>;
  const size_t smem = SMEM ? smem_bytes(n) : 0;
  cudaError_t err = cudaSuccess;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the shared-memory opt-in, only ever raised, and whether one cluster of
  // this size fits, asked once per device and size: a launch inside a
  // CUDA-graph capture makes no other call, and no later launch of a
  // smaller matrix lowers the opt-in below what a captured launch needs
  static int known_device = -1;
  static size_t opted_in[2] = {0, 0};
  static size_t known_smem[2] = {~(size_t)0, ~(size_t)0};
  if (known_device != device) {
    known_device = device;
    opted_in[0] = opted_in[1] = 0;
    known_smem[0] = known_smem[1] = ~(size_t)0;
  }
  if (smem > opted_in[SMEM]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in[SMEM] = smem;
  }
  if (known_smem[SMEM] != smem) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return NO_CLUSTER;
    known_smem[SMEM] = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, s, l, info, work, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// use_smem: the owned rows and the panel copy in shared memory (the caller
// checked that cholesky_smem_bytes(n) fits); otherwise `work` holds
// ceil(n / 32) * 32 * 32 floats for the panel and the rows live in `l`.
extern "C" int ptz_cholesky(const void* s, void* l, void* info, void* work, int n,
                            int use_smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || (!use_smem && work == nullptr)) return (int)cudaErrorInvalidValue;
  return use_smem ? launch<true>((const float*)s, (float*)l, (int*)info, nullptr, n, device,
                                 (cudaStream_t)stream)
                  : launch<false>((const float*)s, (float*)l, (int*)info, (float*)work, n,
                                  device, (cudaStream_t)stream);
}

// Shared memory a block of `device` may opt in to (0 on error): the host's
// plan decides from it whether the rows fit (kernels/cholesky.py:plan).
extern "C" int ptz_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return 0;
  return bytes;
}
