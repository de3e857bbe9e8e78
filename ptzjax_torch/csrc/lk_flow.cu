// Pyramidal Lucas-Kanade tracking for Hopper (sm_90a), kernel E: the whole
// of ptzjax_torch/kernels/flow.py:lk_track in two launches, one that builds
// both frames' pyramids (pyramid_kernel) and one that runs every pyramid
// level of the forward pass, the anchored backward check and the acceptance
// tests (lk_flow_kernel).
//
// Replaces, at its LK call sites, the TPU kernel
// ptzjax/kernels/window_pallas.py:gather_windows_pallas (called from
// ptzjax/kernels/flow.py:_gather for a template and a search window per
// level and per direction), together with what XLA runs next to those
// windows in the same jitted lk_track: the pyramids (flow.py:build_pyramid)
// and the Newton loop (flow.py:_lk_level, _lk_forward). The TPU design
// gathers each window once and samples inside it with selection-matrix
// products on the MXU. The port's first design kept the gather as its own
// kernel (B, 10 launches a call) and ran the rest as ~1,700 small torch
// kernels; its second (one warp a keypoint) left the pyramids to ~160 torch
// kernels, and one warp an SM scheduler hid no latency.
//
// pyramid_kernel: levels b + 1 .. b + n (n <= 3) of up to two frames from
// their level b. A level is the separable (1, 4, 6, 4, 1) / 16 blur,
// edge-padded at that level's own border, along y and then along x (each
// pass the taps summed from tap 0, as Python's sum forms them in the plain
// version), cropped to even size and 2 x 2 mean-pooled. A CTA owns a 32 x 32
// tile of level b + 1 and the tiles above it (16 x 16, 8 x 8), and
// recomputes the halo they need (2 pixels a level, doubling downwards: 14 at
// level b for n = 3) from level b in shared memory, so no CTA waits for
// another. The vertical blur runs down columns, a warp a run of rows with
// five values in registers (the base level read once a run, through the
// L1: each pixel by ~2 CTAs), into shared memory (88 x 92 at most), two
// columns wider on each side than the pool reads, the level's edge
// columns where it ends, so that the horizontal taps need no clamps; the
// horizontal blur and the pool read six columns of two rows as three
// float2 each; each pooled level's region stays in shared memory for the
// next level (44 x 44, 20 x 20), and each CTA writes only the pixels of its
// own tiles. 41.7 KB of static shared memory and 256 threads a CTA; a 720p
// pair at 4 levels is one launch of 12 x 20 x 2 = 480 CTAs. More than 4
// levels take one launch per 3 levels.
//
// lk_flow_kernel: a CTA of 128 threads (four warps) owns a keypoint from
// the first level to the last test:
//   - every thread issues part of each window copy, by cp.async into shared
//     memory from clamped source addresses, so the plain version's edge
//     padding (flow._edge_pad) is addressing and no padded copy of an image
//     is written;
//   - the next level's template window is in flight (a second buffer) while
//     this level's Newton steps run: it depends only on the input position;
//     the search window is in flight while the template is blended and G
//     summed;
//   - the patch's samples are dealt over the CTA's threads (sample s to
//     thread s mod 128: two a thread at most), with the blended template and
//     its gradients in registers;
//   - every sum over the patch is a thread's samples in order, a warp
//     butterfly that carries all of the step's sums together (G's three and
//     the template's sum; the two components of b; the residual's and the
//     std's), then one combine of the four warps' sums in a fixed order
//     through shared memory: the same bits in every thread, so every thread
//     takes the same branch and the same step;
//   - a Newton step's sample is the plain version's selection-matrix
//     product written as what it is: a 4-tap bilinear sample at t =
//     clamp(corner + p, 0, side - 1), along y first and then along x, each
//     pair of taps a product and an FMA (a BLAS accumulating in index
//     order), the weights clamp(1 - |t - j|, 0, 1) as the plain version
//     forms them.
// 512 keypoints are 512 CTAs, ~4 a SM (~16 warps) on the 132 SMs.
//
// What bounds it (chip_smoke.py: lk_work, pyramid_work): bytes. LK at the
// bench shape (512 keypoints, 4 levels and the backward check, patch 13):
// the pixels its windows cover, each read once, and the tables, 3.6 MB,
// 1.08 us at 3.35 TB/s, against ~46 MFLOP (0.68 us at the fp32 peak). The
// pyramids of a 720p pair at 4 levels: 7.4 MB read (both level-0 frames)
// and 2.4 MB written (levels 1-3), 2.9 us. On an H100 SXM (700 W) the LK
// launch takes 0.022 ms, 4.8% of its bound: a Newton step costs ~740 SM
// cycles, as much in issue as in latency, since four CTAs' warps share
// each scheduler; the pyramid launch takes 0.017 ms, 17.5% of its bound:
// the base level's halo, read twice over through the L2, sets its first
// pass (PERF.md).
//
// Numerics: fp32; the file is built with -fmad=false, so an FMA is written
// as __fmaf_rn and every other product and sum rounds once, like the plain
// version's elementwise torch ops. The pyramid's blur repeats the plain
// version's operations and the pool sums its 2 x 2 in the order of torch's
// reduction on the card, so the levels are the plain version's bit for bit
// there. LK's sums over the patch run in another order than torch's. Rows
// with a non-finite position skip the work and come out untracked with the
// input position, as the plain version gives them; rows already rejected
// skip the backward check, which only rejects.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- pyramids

constexpr int kPyrThreads = 256;
constexpr int kPyrWarps = kPyrThreads / 32;
constexpr int kPyrBuild = 3;            // levels a launch builds (flow.PYRAMID_LEVELS_A_LAUNCH)
constexpr int kPyrTile = 32;            // a CTA's tile side at the first level it builds
// a region's side at level b + k (k >= 1) for n = 3: the tile and a halo
// of 2^(n - k + 1) - 2 on each side (44, 20, 8)
constexpr int kLevA = kPyrTile + 2 * ((2 << (kPyrBuild - 1)) - 2);       // level b + 1's: 44
constexpr int kLevB = kPyrTile / 2 + 2 * ((2 << (kPyrBuild - 2)) - 2);   // level b + 2's: 20
// the vertical blur of level b at the 2 x 44 rows and the 2 x 44 + 4
// columns the pool and the horizontal taps read
constexpr int kVbRows = 2 * kLevA;
constexpr int kVbCols = 2 * kLevA + 4;

struct PyrParams {
  const float* base[2];          // level b of each frame
  float* out[2][kPyrBuild];      // levels b + 1 .. b + n of each frame
  int h[kPyrBuild + 1], w[kPyrBuild + 1];   // the sizes of levels b .. b + n
  int n;
};

// One axis of the region of level k (relative to the base) that a CTA
// computes: its tile at that level, widened by the halo the levels above
// it need, clamped to the level.
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span span(int tile, int k, int n, int size) {
  const int side = (2 * kPyrTile) >> k, halo = (2 << (n - k)) - 2;
  return {max(tile * side - halo, 0), min((tile + 1) * side + halo, size)};
}

// The plain version's blur taps over v0..v4: (((0 + k0 v0) + k1 v1) + ...).
__device__ __forceinline__ float blur5(float v0, float v1, float v2, float v3, float v4) {
  float s = __fadd_rn(0.f, __fmul_rn(0.0625f, v0));
  s = __fadd_rn(s, __fmul_rn(0.25f, v1));
  s = __fadd_rn(s, __fmul_rn(0.375f, v2));
  s = __fadd_rn(s, __fmul_rn(0.25f, v3));
  return __fadd_rn(s, __fmul_rn(0.0625f, v4));
}

// The vertical blur of a level (h x w; src with row stride `stride`, its
// rows and columns offset by (top, left): the base level in global memory
// or a region in shared memory) into vb: rows r0 .. r0 + vrows - 1, columns
// c0 .. c0 + vw - 1, each clamped into the level (the plain version's edge
// padding; the columns outside it are the edge's, which the horizontal
// taps then read unclamped). A warp a run of rows, a lane a column of each
// 32-column chunk; a chunk's values are all loaded before its first sum,
// so that they are in flight together.
constexpr int kRunMax = kVbRows / kPyrWarps;               // a warp's rows: 11

template <bool kGlobal>
__device__ __forceinline__ void vertical(float* vb, const float* src, int stride, int top, int left,
                                         int h, int w, int r0, int vrows, int c0, int vw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int run = (vrows + kPyrWarps - 1) / kPyrWarps, ra = warp * run, nr = min(run, vrows - ra);
  if (nr <= 0) return;
#pragma unroll 1
  for (int cc = lane; cc < vw; cc += 32) {
    const float* col = src + (min(max(c0 + cc, 0), w - 1) - left);
    float v[kRunMax + 4];
#pragma unroll
    for (int m = 0; m < kRunMax + 4; ++m) {
      if (m < nr + 4) {
        const float* at = col + (size_t)(min(max(r0 + ra - 2 + m, 0), h - 1) - top) * stride;
        v[m] = kGlobal ? __ldg(at) : *at;
      }
    }
#pragma unroll
    for (int m = 0; m < kRunMax; ++m) {
      if (m < nr) vb[(ra + m) * vw + cc] = blur5(v[m], v[m + 1], v[m + 2], v[m + 3], v[m + 4]);
    }
  }
}

__global__ void __launch_bounds__(kPyrThreads) pyramid_kernel(const PyrParams p) {
  __shared__ __align__(16) float vb[kVbRows * kVbCols];
  __shared__ float lev_a[kLevA * kLevA];
  __shared__ float lev_b[kLevB * kLevB];
  const int f = blockIdx.z, n = p.n;
  const float* lev = nullptr;    // level k's region in shared memory (k >= 1)
  Span ry = span(blockIdx.y, 0, n, p.h[0]), rx = span(blockIdx.x, 0, n, p.w[0]);
#pragma unroll
  for (int k = 0; k < kPyrBuild; ++k) {
    if (k >= n) return;
    const int hk = p.h[k], wk = p.w[k];
    const Span qy = span(blockIdx.y, k + 1, n, p.h[k + 1]), qx = span(blockIdx.x, k + 1, n, p.w[k + 1]);
    if (qy.lo >= qy.hi || qx.lo >= qx.hi) return;   // the whole CTA: nothing of ours from here up
    const int oh = qy.hi - qy.lo, ow = qx.hi - qx.lo, vw = 2 * ow + 4;
    // the vertical blur at the rows the pool reads and the columns the
    // horizontal taps read (2 beyond each side)
    if (k == 0)
      vertical<true>(vb, f ? p.base[1] : p.base[0], wk, 0, 0, hk, wk, 2 * qy.lo, 2 * oh, 2 * qx.lo - 2, vw);
    else
      vertical<false>(vb, lev, rx.hi - rx.lo, ry.lo, rx.lo, hk, wk, 2 * qy.lo, 2 * oh, 2 * qx.lo - 2, vw);
    __syncthreads();
    // the horizontal blur at the 2 x 2 pixels of each pooled pixel (six
    // columns of two rows, three float2 each), and the pool: (b00 + b10) +
    // (b01 + b11), times 1/4 (torch's mean over the two axes on the card
    // sums in that order)
    float* next = k + 1 < n ? (k == 0 ? lev_a : lev_b) : nullptr;
    float* out = f ? p.out[1][k] : p.out[0][k];
    const int side = kPyrTile >> k, oy = blockIdx.y * side, ox = blockIdx.x * side, wn = p.w[k + 1];
    // pooled pixel e = (i, j) to thread e mod 256; i = e / ow through the
    // fp32 reciprocal, exact here (e < 2^11, ow <= 44)
    const float inv_ow = 1.f / (float)ow;
    for (int e = threadIdx.x; e < oh * ow; e += kPyrThreads) {
      const int i = (int)((float)e * inv_ow + 0.5f / (float)ow), j = e - i * ow;
      const float2* a = reinterpret_cast<const float2*>(vb + 2 * i * vw) + j;
      const float2* c = reinterpret_cast<const float2*>(vb + (2 * i + 1) * vw) + j;
      const float2 a0 = a[0], a1 = a[1], a2 = a[2], c0 = c[0], c1 = c[1], c2 = c[2];
      const float b00 = blur5(a0.x, a0.y, a1.x, a1.y, a2.x), b01 = blur5(a0.y, a1.x, a1.y, a2.x, a2.y);
      const float b10 = blur5(c0.x, c0.y, c1.x, c1.y, c2.x), b11 = blur5(c0.y, c1.x, c1.y, c2.x, c2.y);
      const float v = __fmul_rn(__fadd_rn(__fadd_rn(b00, b10), __fadd_rn(b01, b11)), 0.25f);
      if (next) next[e] = v;
      const int gi = qy.lo + i, gj = qx.lo + j;
      if (gi >= oy && gi < oy + side && gj >= ox && gj < ox + side) out[(size_t)gi * wn + gj] = v;
    }
    __syncthreads();
    lev = next;
    ry = qy;
    rx = qx;
  }
}

// ---------------------------------------------------------------------- LK

constexpr int kMaxPatch = 15;    // flow.MAX_PATCH
constexpr int kMaxLevels = 8;    // flow.MAX_LEVELS
constexpr int kDisp = 5;         // flow._DISP: the search window's reach
constexpr int kThreads = 128;    // a CTA a keypoint (flow.WARPS_PER_CTA warps)
constexpr int kWarps = kThreads / 32;
constexpr int kSpt = (kMaxPatch * kMaxPatch + kThreads - 1) / kThreads;   // patch samples a thread
constexpr int kBpt = ((kMaxPatch + 2) * (kMaxPatch + 2) + kThreads - 1) / kThreads;   // blend samples a thread
constexpr int kTmplMax = (kMaxPatch + 3) * (kMaxPatch + 3);
constexpr int kBlendMax = (kMaxPatch + 2) * (kMaxPatch + 2);
constexpr int kSearchMax = (kMaxPatch + 2 * kDisp + 1) * (kMaxPatch + 2 * kDisp + 1);
constexpr int kMaxSums = 4;      // sums a step carries at most

struct Pyramids {
  const float* prev[kMaxLevels];
  const float* next[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

struct Params {
  const float* xy;               // (K, 2) x, y at level 0 of the previous frame
  const unsigned char* valid;    // (K,) bool
  float* xy_out;                 // (K, 2)
  unsigned char* tracked;        // (K,) bool
  float* residual;               // (K,)
  int num, levels, patch, iters, coarse_iters, fb_check;
  float min_eig, max_residual, border, x_max, y_max, fb_tol;
};

// A keypoint's windows: two template windows (patch + 3)^2 (this level's
// and the next one's, in flight), the bilinear blend (patch + 2)^2 and the
// search window (patch + 2 * kDisp + 1)^2, each dense at its runtime side;
// and the warps' partial sums, in two slots used in turns.
struct Smem {
  float tmpl[2][kTmplMax];
  float blend[kBlendMax];
  float search[kSearchMax];
  float part[2][kWarps][kMaxSums];
};

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

// An integral float as an int; beyond +-1e9 (far off any image, where every
// window is clamped to the edge all the same) saturated, so that no
// conversion or later sum overflows.
__device__ __forceinline__ int to_int(float v) { return (int)fminf(fmaxf(v, -1e9f), 1e9f); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Issue this thread's part of the copy of the side x side window of img
// (h x w) whose pixel (0, 0) lies at image (top, left), rows and columns
// clamped into the image: the edge-padded image's window, as flow._edge_pad
// + the clamped start give it. A warp a row, a lane a column (side <= 32);
// one commit group a call.
__device__ __forceinline__ void load_window(float* dst, const float* img, int h, int w, int top,
                                            int left, int side) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < side) {
    const float* col = img + min(max(left + lane, 0), w - 1);
    for (int r = warp; r < side; r += kWarps)
      cp_async4(dst + r * side + lane, col + (size_t)min(max(top + r, 0), h - 1) * w);
  }
  commit();
}

// The sums of N values over the CTA, the same bits in every thread: each
// warp's butterfly (all N together), then warp 0's + warp 1's + ... in
// order through shared memory (slot `slot`, which the call flips).
template <int N>
__device__ __forceinline__ void cta_sum(float (&v)[N], Smem& sm, int& slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __fadd_rn(v[i], __shfl_xor_sync(kFull, v[i], o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) sm.part[slot][warp][i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = sm.part[slot][0][i];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) s = __fadd_rn(s, sm.part[slot][wi][i]);
    v[i] = s;
  }
  slot ^= 1;
}

// flow._patch_starts for a (patch + 2)-sample template at (x, y): the
// image position of its (patch + 3)-side window and its fractional offsets.
struct TmplOrigin {
  int top, left;
  float fy, fx;
};

__device__ __forceinline__ TmplOrigin tmpl_origin(float x, float y, int h, int w, int patch) {
  const int c = (patch + 2) / 2, win = patch + 3, pad = c + 1;
  const int y0 = to_int(floorf(y)), x0 = to_int(floorf(x));
  TmplOrigin o;
  o.top = min(max(y0 - c + pad, 0), h + 2 * pad - win) - pad;
  o.left = min(max(x0 - c + pad, 0), w + 2 * pad - win) - pad;
  o.fy = clamp01(__fsub_rn(y, (float)y0));
  o.fx = clamp01(__fsub_rn(x, (float)x0));
  return o;
}

struct LevelOut {
  float gx, gy, eig, resid;
};

// This thread's patch samples: sample s = threadIdx.x + kThreads k (row p =
// s / patch, column q = s % patch) when s < patch^2.
struct Samples {
  float fp[kSpt], fq[kSpt];
  int at[kSpt];                  // (p + 1) * (patch + 2) + q + 1 in the blend
  bool on[kSpt];
  int blend_at[kBpt];            // blend sample threadIdx.x + kThreads k: its offset in the template window
};

// The bilinear sample of the search window S (side x side) at patch sample
// (fp, fq) for the patch corner (cy, cx) in window coordinates.
__device__ __forceinline__ float window_sample(const float* S, int side, float smax, float cy,
                                               float cx, float fp, float fq) {
  const float ty = fminf(fmaxf(__fadd_rn(cy, fp), 0.f), smax);
  const float tx = fminf(fmaxf(__fadd_rn(cx, fq), 0.f), smax);
  const int i0 = min((int)ty, side - 2), j0 = min((int)tx, side - 2);
  // clamp(1 - |t - j|, 0, 1) at j = i0 and i0 + 1: with t in [i0, i0 + 1]
  // (the clamps above bound it, NaN included) the same bits as
  // 1 - (t - i0) and 1 - ((i0 + 1) - t)
  const float fi0 = (float)i0, fj0 = (float)j0;
  const float wy0 = __fsub_rn(1.f, __fsub_rn(ty, fi0)), wy1 = __fsub_rn(1.f, __fsub_rn(__fadd_rn(fi0, 1.f), ty));
  const float wx0 = __fsub_rn(1.f, __fsub_rn(tx, fj0)), wx1 = __fsub_rn(1.f, __fsub_rn(__fadd_rn(fj0, 1.f), tx));
  const float* r0 = S + i0 * side + j0;
  const float* r1 = r0 + side;
  const float a0 = __fmaf_rn(wy1, r1[0], __fmul_rn(wy0, r0[0]));
  const float a1 = __fmaf_rn(wy1, r1[1], __fmul_rn(wy0, r0[1]));
  return __fmaf_rn(wx1, a1, __fmul_rn(wx0, a0));
}

// One pyramid level of iterative LK for this CTA's keypoint
// (flow._lk_level): the template at (px, py) of the image whose window the
// caller has issued into `tmpl` (at `to`), searched in simg from the guess
// (gx, gy). prefetch() issues one commit group (the next level's template
// window, or none) and may write only into the other template buffer.
template <class Prefetch>
__device__ LevelOut lk_level(Smem& sm, const float* tmpl, const Samples& sp, int& slot, int patch,
                             const TmplOrigin& to, const float* simg, int h, int w, float gx,
                             float gy, int iters, Prefetch prefetch) {
  const int ws = patch + 2 * kDisp + 1, anchor_off = kDisp + patch / 2;
  // the search window: pixel (anchor_off, anchor_off) at round(guess), half
  // to even (flow._search_starts), its start clamped to the padded image
  __syncthreads();   // the last level's samples of the search window are done
  const int top = min(max(to_int(rintf(gy)) - anchor_off + ws, 0), h + ws) - ws;
  const int left = min(max(to_int(rintf(gx)) - anchor_off + ws, 0), w + ws) - ws;
  load_window(sm.search, simg, h, w, top, left, ws);
  prefetch();
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");   // the template; the search window in flight
  __syncthreads();

  // the template: a bilinear blend of the window (flow._sample_patches, its
  // four products summed left to right)
  const int bs = patch + 2, ts = patch + 3;
  const float oy = __fsub_rn(1.f, to.fy), ox = __fsub_rn(1.f, to.fx);
#pragma unroll
  for (int k = 0; k < kBpt; ++k) {
    const int s = threadIdx.x + kThreads * k;
    if (s < bs * bs) {
      const float* t0 = tmpl + sp.blend_at[k];
      const float* t1 = t0 + ts;
      float v = __fmul_rn(__fmul_rn(t0[0], oy), ox);
      v = __fadd_rn(v, __fmul_rn(__fmul_rn(t0[1], oy), to.fx));
      v = __fadd_rn(v, __fmul_rn(__fmul_rn(t1[0], to.fy), ox));
      v = __fadd_rn(v, __fmul_rn(__fmul_rn(t1[1], to.fy), to.fx));
      sm.blend[s] = v;
    }
  }
  __syncthreads();

  // the patch, its central-difference gradients, G and the template's sum
  float tm[kSpt], dgx[kSpt], dgy[kSpt];
  float g[4] = {0.f, 0.f, 0.f, 0.f};   // sxx, sxy, syy, the template's sum
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    const float* c = sm.blend + sp.at[k];
    tm[k] = sp.on[k] ? c[0] : 0.f;
    dgx[k] = sp.on[k] ? __fmul_rn(0.5f, __fsub_rn(c[1], c[-1])) : 0.f;
    dgy[k] = sp.on[k] ? __fmul_rn(0.5f, __fsub_rn(c[bs], c[-bs])) : 0.f;
    g[0] = __fadd_rn(g[0], __fmul_rn(dgx[k], dgx[k]));
    g[1] = __fadd_rn(g[1], __fmul_rn(dgx[k], dgy[k]));
    g[2] = __fadd_rn(g[2], __fmul_rn(dgy[k], dgy[k]));
    g[3] = __fadd_rn(g[3], tm[k]);
  }
  cta_sum(g, sm, slot);
  const float gxx = g[0], gxy = g[1], gyy = g[2];
  const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
  const float tr = __fadd_rn(gxx, gyy);
  const float disc = fmaxf(__fsub_rn(__fmul_rn(tr, tr), __fmul_rn(4.f, det)), 0.f);
  const float n = (float)(patch * patch);
  LevelOut out;
  out.eig = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(tr, sqrtf(disc))), n);
  const float inv_det = det > 1e-12f ? __fdiv_rn(1.f, fmaxf(det, 1e-12f)) : 0.f;
  const float mean = __fdiv_rn(g[3], n);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // the search window; the prefetch in flight
  __syncthreads();

  // Newton steps inside the search window; corner = guess - anchor -
  // (patch - 1) / 2 in window coordinates
  const float ay = (float)top, ax = (float)left, half = 0.5f * (float)(patch - 1);
  const float smax = (float)(ws - 1);
  for (int it = 0; it < iters; ++it) {
    const float cy = __fsub_rn(__fsub_rn(gy, ay), half), cx = __fsub_rn(__fsub_rn(gx, ax), half);
    float b[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kSpt; ++k) {
      if (sp.on[k]) {
        const float di = __fsub_rn(tm[k], window_sample(sm.search, ws, smax, cy, cx, sp.fp[k], sp.fq[k]));
        b[0] = __fadd_rn(b[0], __fmul_rn(di, dgx[k]));
        b[1] = __fadd_rn(b[1], __fmul_rn(di, dgy[k]));
      }
    }
    cta_sum(b, sm, slot);
    const float dx = __fmul_rn(inv_det, __fsub_rn(__fmul_rn(gyy, b[0]), __fmul_rn(gxy, b[1])));
    const float dy = __fmul_rn(inv_det, __fsub_rn(__fmul_rn(gxx, b[1]), __fmul_rn(gxy, b[0])));
    gx = __fadd_rn(gx, dx);
    gy = __fadd_rn(gy, dy);
  }
  // the residual, mean |template - sample|, over the template's population
  // std (two passes: the mean came with G)
  const float cy = __fsub_rn(__fsub_rn(gy, ay), half), cx = __fsub_rn(__fsub_rn(gx, ax), half);
  float r[2] = {0.f, 0.f};   // sum |template - sample|, sum (template - mean)^2
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    if (sp.on[k]) {
      r[0] = __fadd_rn(r[0], fabsf(__fsub_rn(tm[k], window_sample(sm.search, ws, smax, cy, cx, sp.fp[k], sp.fq[k]))));
      const float d = __fsub_rn(tm[k], mean);
      r[1] = __fadd_rn(r[1], __fmul_rn(d, d));
    }
  }
  cta_sum(r, sm, slot);
  const float tstd = sqrtf(__fdiv_rn(r[1], n));
  out.resid = __fdiv_rn(__fdiv_rn(r[0], n), fmaxf(tstd, 1e-6f));
  out.gx = gx;
  out.gy = gy;
  return out;
}

__global__ void __launch_bounds__(kThreads) lk_flow_kernel(const Pyramids pyr, const Params prm) {
  __shared__ Smem sm;
  const int kp = blockIdx.x;
  const float x = prm.xy[2 * kp], y = prm.xy[2 * kp + 1];
  if (!(isfinite(x) && isfinite(y))) {   // the whole CTA leaves together
    if (threadIdx.x == 0) {
      prm.xy_out[2 * kp] = x;
      prm.xy_out[2 * kp + 1] = y;
      prm.tracked[kp] = 0;
      prm.residual[kp] = CUDART_NAN_F;
    }
    return;
  }
  const int patch = prm.patch, levels = prm.levels;
  Samples sp;
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    const int s = threadIdx.x + kThreads * k;
    sp.on[k] = s < patch * patch;
    const int p = sp.on[k] ? s / patch : 0, q = sp.on[k] ? s - p * patch : 0;
    sp.fp[k] = (float)p;
    sp.fq[k] = (float)q;
    sp.at[k] = (p + 1) * (patch + 2) + q + 1;
  }
#pragma unroll
  for (int k = 0; k < kBpt; ++k) {
    const int s = threadIdx.x + kThreads * k, a = s / (patch + 2);
    sp.blend_at[k] = a * (patch + 3) + s - a * (patch + 2);
  }
  int slot = 0;

  // forward: coarse to fine from xy / 2^(levels - 1), the guess doubled
  // between levels (flow._lk_forward)
  const float top_scale = (float)(1 << (levels - 1));
  float gx = __fdiv_rn(x, top_scale), gy = __fdiv_rn(y, top_scale);
  const int lt = levels - 1;
  TmplOrigin to = tmpl_origin(gx, gy, pyr.h[lt], pyr.w[lt], patch);
  int buf = 0;
  load_window(sm.tmpl[buf], pyr.prev[lt], pyr.h[lt], pyr.w[lt], to.top, to.left, patch + 3);
  LevelOut lv{};
  for (int lvl = levels - 1; lvl >= 0; --lvl) {
    TmplOrigin next_to{};
    auto prefetch = [&]() {
      if (lvl > 0) {   // the next level's template depends only on xy
        const float sc = (float)(1 << (lvl - 1));
        next_to = tmpl_origin(__fdiv_rn(x, sc), __fdiv_rn(y, sc), pyr.h[lvl - 1], pyr.w[lvl - 1], patch);
        load_window(sm.tmpl[buf ^ 1], pyr.prev[lvl - 1], pyr.h[lvl - 1], pyr.w[lvl - 1], next_to.top,
                    next_to.left, patch + 3);
      } else {
        commit();
      }
    };
    lv = lk_level(sm, sm.tmpl[buf], sp, slot, patch, to, pyr.next[lvl], pyr.h[lvl], pyr.w[lvl], gx, gy,
                  lvl == 0 ? prm.iters : prm.coarse_iters, prefetch);
    gx = lv.gx;
    gy = lv.gy;
    if (lvl > 0) {
      gx = __fmul_rn(gx, 2.f);
      gy = __fmul_rn(gy, 2.f);
      to = next_to;
      buf ^= 1;
    }
  }
  // the acceptance tests of lk_track at level 0 of the next frame (the
  // same bits in every thread)
  bool ok = prm.valid[kp] != 0 && lv.eig > prm.min_eig && lv.resid < prm.max_residual &&
            gx >= prm.border && gx <= prm.x_max && gy >= prm.border && gy <= prm.y_max &&
            isfinite(gx) && isfinite(gy);
  if (ok && prm.fb_check) {
    // the anchored backward check: one full-resolution level, the template
    // from the next frame at the tracked position, searched in the
    // previous frame from the input position (the template buffer not in
    // use: every read of the other ended before the last level's G)
    const TmplOrigin bt = tmpl_origin(gx, gy, pyr.h[0], pyr.w[0], patch);
    load_window(sm.tmpl[buf ^ 1], pyr.next[0], pyr.h[0], pyr.w[0], bt.top, bt.left, patch + 3);
    const LevelOut back = lk_level(sm, sm.tmpl[buf ^ 1], sp, slot, patch, bt, pyr.prev[0], pyr.h[0],
                                   pyr.w[0], x, y, prm.iters, [] { commit(); });
    const float dx = __fsub_rn(back.gx, x), dy = __fsub_rn(back.gy, y);
    ok = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))) < prm.fb_tol;
  }
  if (threadIdx.x == 0) {
    prm.xy_out[2 * kp] = ok ? gx : x;
    prm.xy_out[2 * kp + 1] = ok ? gy : y;
    prm.tracked[kp] = ok ? 1 : 0;
    prm.residual[kp] = lv.resid;
  }
}

}  // namespace

extern "C" int ptz_pyramid(const void* const* base, void* const* out, const int* heights,
                           const int* widths, int frames, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (frames < 1 || frames > 2 || n < 1 || n > kPyrBuild) return (int)cudaErrorInvalidValue;
  PyrParams p{};
  for (int k = 0; k <= n; ++k) {
    if (heights[k] < 1 || widths[k] < 1) return (int)cudaErrorInvalidValue;
    p.h[k] = heights[k];
    p.w[k] = widths[k];
  }
  for (int f = 0; f < frames; ++f) {
    p.base[f] = (const float*)base[f];
    for (int k = 0; k < n; ++k) p.out[f][k] = (float*)out[f * n + k];
  }
  p.n = n;
  const dim3 grid((p.w[1] + kPyrTile - 1) / kPyrTile, (p.h[1] + kPyrTile - 1) / kPyrTile, frames);
  pyramid_kernel<<<grid, kPyrThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int ptz_lk_flow(const void* const* prev, const void* const* next, const int* heights,
                           const int* widths, int levels, const void* xy, const void* valid,
                           void* xy_out, void* tracked, void* residual, int num, int patch,
                           int iters, int coarse_iters, float min_eig, float max_residual,
                           float border, float x_max, float y_max, float fb_tol, int fb_check,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (levels < 1 || levels > kMaxLevels || patch < 1 || patch > kMaxPatch || patch % 2 == 0 ||
      num < 0)
    return (int)cudaErrorInvalidValue;
  if (num == 0) return (int)cudaSuccess;
  Pyramids pyr{};
  for (int l = 0; l < levels; ++l) {
    if (heights[l] < 1 || widths[l] < 1) return (int)cudaErrorInvalidValue;
    pyr.prev[l] = (const float*)prev[l];
    pyr.next[l] = (const float*)next[l];
    pyr.h[l] = heights[l];
    pyr.w[l] = widths[l];
  }
  Params prm{(const float*)xy, (const unsigned char*)valid, (float*)xy_out,
             (unsigned char*)tracked, (float*)residual, num, levels, patch, iters, coarse_iters,
             fb_check, min_eig, max_residual, border, x_max, y_max, fb_tol};
  lk_flow_kernel<<<num, kThreads, 0, (cudaStream_t)stream>>>(pyr, prm);
  return (int)cudaGetLastError();
}
