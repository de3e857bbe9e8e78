// Pyramidal Lucas-Kanade tracking for Hopper (sm_90a), kernel E: every
// pyramid level of the forward pass, the anchored backward check and the
// acceptance tests of ptzjax_torch/kernels/flow.py:lk_track in one launch.
//
// Replaces, at its LK call sites, the TPU kernel
// ptzjax/kernels/window_pallas.py:gather_windows_pallas (called from
// ptzjax/kernels/flow.py:_gather for a template and a search window per
// level and per direction), together with the Newton loop that XLA runs
// next to those windows (flow.py:_lk_level, _lk_forward, lk_track). The
// TPU design gathers each window once and samples inside it with
// selection-matrix products on the MXU. The port's first design kept the
// gather as its own kernel (B, 10 launches a call) and ran the loop as
// some 1,700 small torch kernels, each a round trip through device memory
// and ~25 us of host issue. Here one warp owns a keypoint from the first
// level to the last test:
//   - its windows land in shared memory by cp.async from clamped source
//     addresses, so the plain version's edge padding (flow._edge_pad) is
//     addressing and no padded copy of an image is written;
//   - the next level's template window is in flight while this level's
//     Newton steps run (it depends only on the input position);
//   - the blended template, its gradients, G, the Newton loop and the
//     residual stay in registers and shared memory; sums over the patch
//     are warp-shuffle butterflies, which leave the same bits in every
//     lane, so every lane takes the same branch and the same step;
//   - a Newton step's sample is the plain version's selection-matrix
//     product written as what it is: a 4-tap bilinear sample at t =
//     clamp(corner + p, 0, side - 1), along y first and then along x, each
//     pair of taps a product and an FMA (a BLAS accumulating in index
//     order), the weights clamp(1 - |t - j|, 0, 1) as the plain version
//     forms them.
// Four warps (keypoints) a CTA: 128 CTAs for 512 keypoints, one wave on
// the 132 SMs.
//
// What bounds it: the windows it must read, at the bench shape (512
// keypoints, 4 levels and the backward check, patch 13) 512 x 5 x (16^2 +
// 24^2) x 4 B = 8.5 MB with the overlaps, 2.5 us at 3.35 TB/s, against
// ~50 MFLOP (0.7 us at the fp32 peak). With one warp a keypoint an SM
// holds about 4 warps, so the latency of each warp's 33 dependent
// sample-and-reduce steps, not either bound, sets its time.
//
// Numerics: fp32; the file is built with -fmad=false, so an FMA is written
// as __fmaf_rn and every other product and sum rounds once, like the plain
// version's elementwise torch ops; sums over the patch run in another
// order than torch's. Rows with a non-finite position skip the work and
// come out untracked with the input position, as the plain version gives
// them; rows already rejected skip the backward check, which only rejects.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxPatch = 15;    // flow.MAX_PATCH
constexpr int kMaxLevels = 8;    // flow.MAX_LEVELS
constexpr int kDisp = 5;         // flow._DISP: the search window's reach
constexpr int kWarps = 4;        // keypoints a CTA (flow.WARPS_PER_CTA)
constexpr int kSpl = (kMaxPatch * kMaxPatch + 31) / 32;   // patch samples a lane
constexpr int kTmplMax = (kMaxPatch + 3) * (kMaxPatch + 3);
constexpr int kBlendMax = (kMaxPatch + 2) * (kMaxPatch + 2);
constexpr int kSearchMax = (kMaxPatch + 2 * kDisp + 1) * (kMaxPatch + 2 * kDisp + 1);
constexpr unsigned kFull = 0xffffffffu;

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

// A warp's windows: the template window (patch + 3)^2, its bilinear blend
// (patch + 2)^2 and the search window (patch + 2 * kDisp + 1)^2, each
// dense at its runtime side.
struct WarpSmem {
  float tmpl[kTmplMax];
  float blend[kBlendMax];
  float search[kSearchMax];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

// An integral float as an int; beyond +-1e9 (far off any image, where every
// window is clamped to the edge all the same) saturated, so that no
// conversion or later sum overflows.
__device__ __forceinline__ int to_int(float v) { return (int)fminf(fmaxf(v, -1e9f), 1e9f); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Issue the copy of the side x side window of img (h x w) whose pixel
// (0, 0) lies at image (top, left), rows and columns clamped into the
// image: the edge-padded image's window, as flow._edge_pad + the clamped
// start give it. One row a step, a lane a column.
__device__ __forceinline__ void load_window(float* dst, const float* img, int h, int w, int top,
                                            int left, int side, int lane) {
  if (lane < side) {
    const float* col = img + min(max(left + lane, 0), w - 1);
    for (int r = 0; r < side; ++r) {
      const int row = min(max(top + r, 0), h - 1);
      cp_async4(dst + r * side + lane, col + (size_t)row * w);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
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

// Per-lane patch samples: sample s = lane + 32 k (row p = s / patch,
// column q = s % patch) when s < patch^2.
struct Samples {
  float fp[kSpl], fq[kSpl];
  int at[kSpl];                  // (p + 1) * (patch + 2) + q + 1 in the blend
  bool on[kSpl];
};

// The bilinear sample of the search window S (side x side) at patch sample
// (fp, fq) for the patch corner (cy, cx) in window coordinates.
__device__ __forceinline__ float window_sample(const float* S, int side, float smax, float cy,
                                               float cx, float fp, float fq) {
  const float ty = fminf(fmaxf(__fadd_rn(cy, fp), 0.f), smax);
  const float tx = fminf(fmaxf(__fadd_rn(cx, fq), 0.f), smax);
  const int i0 = min((int)ty, side - 2), j0 = min((int)tx, side - 2);
  const float wy0 = clamp01(__fsub_rn(1.f, fabsf(__fsub_rn(ty, (float)i0))));
  const float wy1 = clamp01(__fsub_rn(1.f, fabsf(__fsub_rn(ty, (float)(i0 + 1)))));
  const float wx0 = clamp01(__fsub_rn(1.f, fabsf(__fsub_rn(tx, (float)j0))));
  const float wx1 = clamp01(__fsub_rn(1.f, fabsf(__fsub_rn(tx, (float)(j0 + 1)))));
  const float* r0 = S + i0 * side + j0;
  const float* r1 = r0 + side;
  const float a0 = __fmaf_rn(wy1, r1[0], __fmul_rn(wy0, r0[0]));
  const float a1 = __fmaf_rn(wy1, r1[1], __fmul_rn(wy0, r0[1]));
  return __fmaf_rn(wx1, a1, __fmul_rn(wx0, a0));
}

// One pyramid level of iterative LK for this warp's keypoint
// (flow._lk_level): the template at (px, py) of the image whose window the
// caller has issued into sm.tmpl (at `to`), searched in simg from the guess
// (gx, gy). after_blend() runs once the template window is free.
template <class AfterBlend>
__device__ LevelOut lk_level(WarpSmem& sm, const Samples& sp, int lane, int patch, const TmplOrigin& to,
                             const float* simg, int h, int w, float gx, float gy, int iters,
                             AfterBlend after_blend) {
  const int ws = patch + 2 * kDisp + 1, anchor_off = kDisp + patch / 2;
  // the search window: pixel (anchor_off, anchor_off) at round(guess), half
  // to even (flow._search_starts), its start clamped to the padded image
  __syncwarp();
  const int top = min(max(to_int(rintf(gy)) - anchor_off + ws, 0), h + ws) - ws;
  const int left = min(max(to_int(rintf(gx)) - anchor_off + ws, 0), w + ws) - ws;
  load_window(sm.search, simg, h, w, top, left, ws, lane);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // the template: a bilinear blend of the window (flow._sample_patches, its
  // four products summed left to right)
  const int bs = patch + 2, ts = patch + 3;
  const float oy = __fsub_rn(1.f, to.fy), ox = __fsub_rn(1.f, to.fx);
  for (int s = lane; s < bs * bs; s += 32) {
    const int a = s / bs, b = s - a * bs;
    const float* t0 = sm.tmpl + a * ts + b;
    const float* t1 = t0 + ts;
    float v = __fmul_rn(__fmul_rn(t0[0], oy), ox);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(t0[1], oy), to.fx));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(t1[0], to.fy), ox));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(t1[1], to.fy), to.fx));
    sm.blend[s] = v;
  }
  __syncwarp();
  after_blend();

  // the patch, its central-difference gradients and G
  float tm[kSpl], dgx[kSpl], dgy[kSpl];
  float sxx = 0.f, sxy = 0.f, syy = 0.f, st = 0.f;
#pragma unroll
  for (int k = 0; k < kSpl; ++k) {
    const float* c = sm.blend + sp.at[k];
    tm[k] = sp.on[k] ? c[0] : 0.f;
    dgx[k] = sp.on[k] ? __fmul_rn(0.5f, __fsub_rn(c[1], c[-1])) : 0.f;
    dgy[k] = sp.on[k] ? __fmul_rn(0.5f, __fsub_rn(c[bs], c[-bs])) : 0.f;
    sxx = __fadd_rn(sxx, __fmul_rn(dgx[k], dgx[k]));
    sxy = __fadd_rn(sxy, __fmul_rn(dgx[k], dgy[k]));
    syy = __fadd_rn(syy, __fmul_rn(dgy[k], dgy[k]));
    st = __fadd_rn(st, tm[k]);
  }
  const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
  const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
  const float tr = __fadd_rn(gxx, gyy);
  const float disc = fmaxf(__fsub_rn(__fmul_rn(tr, tr), __fmul_rn(4.f, det)), 0.f);
  const float n = (float)(patch * patch);
  LevelOut out;
  out.eig = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(tr, sqrtf(disc))), n);
  const float inv_det = det > 1e-12f ? __fdiv_rn(1.f, fmaxf(det, 1e-12f)) : 0.f;
  // the template's population std, two passes
  const float mean = __fdiv_rn(warp_sum(st), n);
  float sv = 0.f;
#pragma unroll
  for (int k = 0; k < kSpl; ++k) {
    const float d = sp.on[k] ? __fsub_rn(tm[k], mean) : 0.f;
    sv = __fadd_rn(sv, __fmul_rn(d, d));
  }
  const float tstd = sqrtf(__fdiv_rn(warp_sum(sv), n));

  // Newton steps inside the search window; corner = guess - anchor -
  // (patch - 1) / 2 in window coordinates
  const float ay = (float)top, ax = (float)left, half = 0.5f * (float)(patch - 1);
  const float smax = (float)(ws - 1);
  for (int it = 0; it < iters; ++it) {
    const float cy = __fsub_rn(__fsub_rn(gy, ay), half), cx = __fsub_rn(__fsub_rn(gx, ax), half);
    float bx = 0.f, by = 0.f;
#pragma unroll
    for (int k = 0; k < kSpl; ++k) {
      if (sp.on[k]) {
        const float di = __fsub_rn(tm[k], window_sample(sm.search, ws, smax, cy, cx, sp.fp[k], sp.fq[k]));
        bx = __fadd_rn(bx, __fmul_rn(di, dgx[k]));
        by = __fadd_rn(by, __fmul_rn(di, dgy[k]));
      }
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float dx = __fmul_rn(inv_det, __fsub_rn(__fmul_rn(gyy, bx), __fmul_rn(gxy, by)));
    const float dy = __fmul_rn(inv_det, __fsub_rn(__fmul_rn(gxx, by), __fmul_rn(gxy, bx)));
    gx = __fadd_rn(gx, dx);
    gy = __fadd_rn(gy, dy);
  }
  // the residual: mean |template - sample| over the template's std
  const float cy = __fsub_rn(__fsub_rn(gy, ay), half), cx = __fsub_rn(__fsub_rn(gx, ax), half);
  float sa = 0.f;
#pragma unroll
  for (int k = 0; k < kSpl; ++k) {
    if (sp.on[k])
      sa = __fadd_rn(sa, fabsf(__fsub_rn(tm[k], window_sample(sm.search, ws, smax, cy, cx, sp.fp[k], sp.fq[k]))));
  }
  out.resid = __fdiv_rn(__fdiv_rn(warp_sum(sa), n), fmaxf(tstd, 1e-6f));
  out.gx = gx;
  out.gy = gy;
  return out;
}

__global__ void __launch_bounds__(32 * kWarps) lk_flow_kernel(const Pyramids pyr, const Params prm) {
  __shared__ WarpSmem smem[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarps + warp;
  if (kp >= prm.num) return;
  WarpSmem& sm = smem[warp];
  const float x = prm.xy[2 * kp], y = prm.xy[2 * kp + 1];
  if (!(isfinite(x) && isfinite(y))) {
    if (lane == 0) {
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
  for (int k = 0; k < kSpl; ++k) {
    const int s = lane + 32 * k;
    sp.on[k] = s < patch * patch;
    const int p = sp.on[k] ? s / patch : 0, q = sp.on[k] ? s - p * patch : 0;
    sp.fp[k] = (float)p;
    sp.fq[k] = (float)q;
    sp.at[k] = (p + 1) * (patch + 2) + q + 1;
  }

  // forward: coarse to fine from xy / 2^(levels - 1), the guess doubled
  // between levels (flow._lk_forward)
  const float top_scale = (float)(1 << (levels - 1));
  float gx = __fdiv_rn(x, top_scale), gy = __fdiv_rn(y, top_scale);
  const int lt = levels - 1;
  TmplOrigin to = tmpl_origin(gx, gy, pyr.h[lt], pyr.w[lt], patch);
  load_window(sm.tmpl, pyr.prev[lt], pyr.h[lt], pyr.w[lt], to.top, to.left, patch + 3, lane);
  LevelOut lv{};
  for (int lvl = levels - 1; lvl >= 0; --lvl) {
    TmplOrigin next_to{};
    auto prefetch = [&]() {
      if (lvl > 0) {   // the next level's template depends only on xy
        const float sc = (float)(1 << (lvl - 1));
        next_to = tmpl_origin(__fdiv_rn(x, sc), __fdiv_rn(y, sc), pyr.h[lvl - 1], pyr.w[lvl - 1], patch);
        load_window(sm.tmpl, pyr.prev[lvl - 1], pyr.h[lvl - 1], pyr.w[lvl - 1], next_to.top,
                    next_to.left, patch + 3, lane);
      }
    };
    lv = lk_level(sm, sp, lane, patch, to, pyr.next[lvl], pyr.h[lvl], pyr.w[lvl], gx, gy,
                  lvl == 0 ? prm.iters : prm.coarse_iters, prefetch);
    gx = lv.gx;
    gy = lv.gy;
    if (lvl > 0) {
      gx = __fmul_rn(gx, 2.f);
      gy = __fmul_rn(gy, 2.f);
      to = next_to;
    }
  }
  // the acceptance tests of lk_track at level 0 of the next frame
  bool ok = prm.valid[kp] != 0 && lv.eig > prm.min_eig && lv.resid < prm.max_residual &&
            gx >= prm.border && gx <= prm.x_max && gy >= prm.border && gy <= prm.y_max &&
            isfinite(gx) && isfinite(gy);
  if (ok && prm.fb_check) {
    // the anchored backward check: one full-resolution level, the template
    // from the next frame at the tracked position, searched in the
    // previous frame from the input position
    const TmplOrigin bt = tmpl_origin(gx, gy, pyr.h[0], pyr.w[0], patch);
    __syncwarp();
    load_window(sm.tmpl, pyr.next[0], pyr.h[0], pyr.w[0], bt.top, bt.left, patch + 3, lane);
    const LevelOut back = lk_level(sm, sp, lane, patch, bt, pyr.prev[0], pyr.h[0], pyr.w[0], x, y,
                                   prm.iters, [] {});
    const float dx = __fsub_rn(back.gx, x), dy = __fsub_rn(back.gy, y);
    ok = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))) < prm.fb_tol;
  }
  if (lane == 0) {
    prm.xy_out[2 * kp] = ok ? gx : x;
    prm.xy_out[2 * kp + 1] = ok ? gy : y;
    prm.tracked[kp] = ok ? 1 : 0;
    prm.residual[kp] = lv.resid;
  }
}

}  // namespace

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
  lk_flow_kernel<<<(num + kWarps - 1) / kWarps, 32 * kWarps, 0, (cudaStream_t)stream>>>(pyr, prm);
  return (int)cudaGetLastError();
}
