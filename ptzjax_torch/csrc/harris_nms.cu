// Keypoint detection maps for Hopper (sm_90a), in one launch: Harris
// response, 3x3 non-maximum suppression, the detection mask, the border,
// the subpixel fit at every survivor and the response floor.
//
// Replaces the TPU kernel ptzjax/kernels/detect_pallas.py:harris_nms_pallas
// and the full-frame passes that followed it in detect_keypoints. For an
// (H, W) fp32 image and an optional (H, W) bool mask it writes
//   sup   (H, W): the NMS survivors inside the border and allowed by the
//         mask, -1e30 elsewhere;
//   off   (H, W, 2): the quadratic subpixel offsets (off_x, off_y) at every
//         survivor (elsewhere untouched);
//   floor (1,): threshold * max(max(sup), 1e-20).
// The raw response never reaches device memory.
//
// What bounds it on the card: bytes. It must read 4 B of image (and 1 B of
// mask) and write 4 B of sup per pixel, plus 8 B per survivor: 7.4 MB at
// 720p, 2.2 us at 3.35 TB/s. The work, ~80 fp32 operations a pixel, is
// 1.1 us at the fp32 peak. The first design ran five shared-memory phases
// behind four block barriers on 16 x 32 tiles, ~65 shared accesses and 1.9x
// halo reads per output, in 1.7 waves: 17% of this bound. This design keeps
// the stencil in registers:
//   - a warp owns a strip of 64 columns, 56 outputs with a 4-px halo on each
//     side (two columns a lane), and a run of kRun = 8 rows (at 720p, 2,070
//     warps, all resident at once: runs of 16 and 32 rows ran slower, with
//     half and a quarter of the warps); rows are loaded 3 steps ahead of
//     their use;
//   - the run is unrolled, so the last 3 image rows (Iy), the 5-row window
//     of each of the three products (the vertical 5-tap) and the last 3
//     response rows (NMS and the subpixel fit) are static registers, with
//     no copying; neighbours across lanes come from __shfl_sync, and no
//     shuffle sits under a branch the compiler cannot prove uniform (each
//     such shuffle cost a WARPSYNC/ENDCOLLECTIVE pair);
//   - each row's epilogue applies the mask and the border and writes sup;
//     survivors (NMS keeps no two adjacent pixels, so at most a quarter)
//     go to a queue in shared memory and get their subpixel fit, with its
//     IEEE divisions, after the run, a lane each (fitted in the row loop,
//     the divisions ran in most rows for the whole warp);
//   - the warp and CTA reduce the max of sup, and the last CTA (ticket
//     counter, reset to 0 by that CTA) reduces the per-CTA maxima and
//     writes floor. A float max does not depend on the order, so the
//     result is deterministic.
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3a; PERF.md has
// the runs) it takes about 0.0115 ms at 720p, some 20% of the bound. What
// holds it is instruction issue in a grid of only ~2,000 serial runs: about
// 250 instructions a lane per row step, 40% of them the fp32 arithmetic
// whose rounding the plain version fixes. (Fusing the power-of-two taps into
// FMAs ran 9% faster, but rounds differently where a tap's product is
// subnormal, so it is not used.)
//
// Semantics are those of the plain torch version (kernels/harris_nms.py)
// everywhere: every stage reads its input at clamped coordinates, which is
// what the plain version's edge padding of that stage's input means (the
// image for the gradients, each product map for the vertical pass, each
// vertically smoothed map for the horizontal pass); the NMS sees -1e30
// outside the image. Rows outside the image repeat the edge row's
// products, and a lane computes its products at its clamped columns (with
// their clamped neighbours), so the lane of a column outside the image
// holds the edge column's values. Taps are summed in the plain order, one
// rounding per operation (built with -fmad=false), and the fit divides in
// IEEE. The caller guarantees border >= 1, so a survivor is never on the
// image's edge and the fit's clamped centre is the survivor itself.

#include <cuda_runtime.h>

namespace {

constexpr int kHalo = 4;               // columns of halo on each side
constexpr int kStrip = 64 - 2 * kHalo; // output columns per warp (2 a lane)
constexpr int kWarps = 4;              // warps per CTA
constexpr int kRun = 8;                // output rows per warp
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// (1, 4, 6, 4, 1) / 16 summed left to right as the plain version does. The
// plain version starts from +0 (zeros + k0 a0); this starts from k0 a0,
// which differs only in the sign of a zero sum of the Ixy channel, and
// the response reads that channel only through Ixy^2.
__device__ __forceinline__ float smooth5(float a0, float a1, float a2,
                                         float a3, float a4) {
  float s = 0.0625f * a0;
  s = s + 0.25f * a1;
  s = s + 0.375f * a2;
  s = s + 0.25f * a3;
  s = s + 0.0625f * a4;
  return s;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float up(float v) { return __shfl_up_sync(kFull, v, 1); }
__device__ __forceinline__ float down(float v) { return __shfl_down_sync(kFull, v, 1); }

// The quadratic 1-D fit through c and its neighbours l, r: -(r - l) / 2 over
// (r + l) - 2c, 0 where that curvature is below 1e-12, clamped to +-0.5.
__device__ __forceinline__ float fit(float l, float c, float r) {
  const float dx = 0.5f * (r - l);
  const float dxx = (r + l) - 2.0f * c;
  const float q = __fdiv_rn(-dx, dxx);   // inf or nan where dxx is 0: not taken
  return fminf(fmaxf(fabsf(dxx) > 1e-12f ? q : 0.0f, -0.5f), 0.5f);
}

// NMS: strictly greater than the 4 "previous" neighbours, at least equal
// to the 4 "next" ones, so a plateau keeps exactly one pixel.
__device__ __forceinline__ bool nms(float c, float ul, float u, float ur, float l, float rt,
                                    float dl, float d, float dr) {
  return c > fmaxf(fmaxf(ul, u), fmaxf(ur, l)) && c >= fmaxf(fmaxf(rt, dl), fmaxf(d, dr));
}

// Survivors a warp may queue in one run: NMS keeps no two adjacent pixels,
// so at most one in each 2 x 2 block of its 56 x kRun outputs.
constexpr int kQueue = (kStrip / 2) * ((kRun + 1) / 2);

// A queued survivor: its pixel, response and the 4 neighbours the fit reads.
struct Cand {
  int o;
  float c, l, r, u, d;
};

// A warp owns kStrip output columns (lane t holds columns x0 - 4 + 2t and
// the next) and kRun output rows from ys. The run is unrolled: step j works
// on row r = ys - 3 + j (its products), r - 2 (response) and r - 3 (the
// output row), so every window is a static register. Survivors go to a
// queue in shared memory and are fitted after the run. EVEN: the width is
// even, so a lane's two columns are one aligned 8-byte access.
template <bool EVEN>
__global__ void __launch_bounds__(32 * kWarps) detect_kernel(
    const float* __restrict__ img, const unsigned char* __restrict__ mask,
    float* __restrict__ sup, float2* __restrict__ off, float* cta_max,
    unsigned* counter, float* __restrict__ floor_out, int h, int w,
    int border, int n_strips, int n_runs, float threshold, float k, int zero) {
  constexpr int STEPS = kRun + 6;
  constexpr int AHEAD = 3;   // steps a row is loaded before its first use
  __shared__ Cand s_queue[kWarps][kQueue];
  __shared__ float s_max[kWarps];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int g = blockIdx.x * kWarps + wid;
  float run_max = kNeg;

  // A warp past the grid's end computes a copy of the last run and writes
  // nothing, so no branch depends on the warp.
  const int total = n_strips * n_runs;
  const bool active = g < total;
  const int gg = active ? g : total - 1;
  const int x0 = (gg % n_strips) * kStrip;
  const int ys = (gg / n_strips) * kRun;
  const int ca = x0 - kHalo + 2 * lane, cb = ca + 1;
  const int xa = clampi(ca, 0, w - 1), xb = clampi(cb, 0, w - 1);
  const bool in_a = ca >= 0 && ca < w, in_b = cb >= 0 && cb < w;
  // output lanes; on an even width both columns of one are in or out
  const bool writes = active && lane >= kHalo / 2 && lane < 32 - kHalo / 2;
  // columns where a survivor may stand (inside the border)
  const bool xs_a = writes && ca >= border && ca < w - border;
  const bool xs_b = writes && cb >= border && cb < w - border;
  // the outer neighbours of the two (clamped) columns, for the gradients
  const int xam = clampi(xa - 1, 0, w - 1), xbp = clampi(xb + 1, 0, w - 1);
  const int x2 = EVEN ? clampi(ca, 0, w - 2) : 0;   // the aligned pair holding xa, xb

  // image rows clamp(ys - 4 .. ys + kRun + 3) at the two clamped columns and,
  // for rows 1 .. kRun + 6 (each the middle row of one step), at their
  // outer neighbours. Row i is loaded in step i - 2 - AHEAD: its address
  // takes a zero from that step's data, so the loads stay AHEAD steps
  // ahead of their use instead of all being hoisted to the start, which
  // would hold every row in registers.
  float ia[kRun + 8], ib[kRun + 8], am[kRun + 8], bp[kRun + 8];
  auto load_row = [&](int i, int dep) {
    const float* row = img + clampi(ys - 4 + i, 0, h - 1) * w + (dep & zero);
    if (EVEN) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(row + x2));
      ia[i] = ca >= w ? v.y : v.x;
      ib[i] = cb < 0 ? v.x : v.y;
    } else {
      ia[i] = __ldg(row + xa);
      ib[i] = __ldg(row + xb);
    }
    if (i >= 1 && i <= kRun + 6) {
      am[i] = __ldg(row + xam);
      bp[i] = __ldg(row + xbp);
    }
  };
#pragma unroll
  for (int i = 0; i < AHEAD + 2; ++i) load_row(i, 0);

  int queued = 0;   // survivors in this warp's queue (warp-uniform)
  float pa[3][STEPS], pb[3][STEPS];   // Ixx, Iyy, Ixy at row clamp(r)
  float ra[STEPS], rb[STEPS];         // the response at row r - 2
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const int r = ys - 3 + j;
    if (j + AHEAD + 2 < kRun + 8)
      load_row(j + AHEAD + 2, __float_as_int(j > 0 ? pa[0][j - 1] : ia[0]));
    // central differences at the clamped columns; rows j, j + 1, j + 2 are
    // clamp(r - 1 .. r + 1), which is right for 0 <= r < h (the products of
    // other rows are replaced below). Column xa + 1 is xb and xb - 1 is xa
    // except where the pair is clamped.
    const float a_next = ca < 0 ? bp[j + 1] : ib[j + 1];
    const float b_prev = cb > w - 1 ? am[j + 1] : ia[j + 1];
    const float ga = 0.5f * (a_next - am[j + 1]);
    const float gb = 0.5f * (bp[j + 1] - b_prev);
    const float ha = 0.5f * (ia[j + 2] - ia[j]);
    const float hb = 0.5f * (ib[j + 2] - ib[j]);
    const float qa[3] = {ga * ga, ha * ha, ga * ha};
    const float qb[3] = {gb * gb, hb * hb, gb * hb};
    // rows past the bottom repeat row h - 1's products (the step before)
    const bool below = j > 0 && r >= h;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pa[c][j] = below ? pa[c][j > 0 ? j - 1 : 0] : qa[c];
      pb[c][j] = below ? pb[c][j > 0 ? j - 1 : 0] : qb[c];
    }
    if (j == 3) {
      // rows above the top (steps 0-2 of the first run) repeat row 0's
      const bool top = ys == 0;
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          pa[c][i] = top ? pa[c][3] : pa[c][i];
          pb[c][i] = top ? pb[c][3] : pb[c][i];
        }
    }
    if (j < 4) continue;

    // vertical pass, then horizontal pass with lanes -1 and +1, then the
    // response at row r - 2; -1e30 outside the image (NMS padding)
    float sa[3], sb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float va = smooth5(pa[c][j - 4], pa[c][j - 3], pa[c][j - 2], pa[c][j - 1], pa[c][j]);
      const float vb = smooth5(pb[c][j - 4], pb[c][j - 3], pb[c][j - 2], pb[c][j - 1], pb[c][j]);
      const float la = up(va), lb = up(vb), na = down(va), nb = down(vb);
      sa[c] = smooth5(la, lb, va, vb, na);
      sb[c] = smooth5(lb, va, vb, na, nb);
    }
    const bool row_in = r - 2 >= 0 && r - 2 < h;
    {
      const float det = sa[0] * sa[1] - sa[2] * sa[2];
      const float tr = sa[0] + sa[1];
      ra[j] = row_in && in_a ? det - k * tr * tr : kNeg;
    }
    {
      const float det = sb[0] * sb[1] - sb[2] * sb[2];
      const float tr = sb[0] + sb[1];
      rb[j] = row_in && in_b ? det - k * tr * tr : kNeg;
    }
    if (j < 6) continue;

    // 3x3 NMS at row y = r - 3: rows j - 2, j - 1, j are y - 1, y, y + 1
    const int y = r - 3;
    const float ml = up(rb[j - 2]), mr = down(ra[j - 2]);
    const float cl = up(rb[j - 1]), cr = down(ra[j - 1]);
    const float pl = up(rb[j]), pr = down(ra[j]);
    const bool y_in = y < h, ys_in = y >= border && y < h - border;
    const int o = y * w + ca;   // pixel index of column a
    bool ma = true, mb = true;
    if (mask != nullptr) {
      if (EVEN) {
        const uchar2 m2 = (xs_a || xs_b) && ys_in ? *reinterpret_cast<const uchar2*>(mask + o)
                                                  : make_uchar2(0, 0);
        ma = m2.x != 0;
        mb = m2.y != 0;
      } else {
        ma = xs_a && ys_in && mask[o] != 0;
        mb = xs_b && ys_in && mask[o + 1] != 0;
      }
    }
    const float ca_ = ra[j - 1], cb_ = rb[j - 1];
    const bool ka = ys_in && xs_a && ma &&
                    nms(ca_, ml, ra[j - 2], rb[j - 2], cl, cb_, pl, ra[j], rb[j]);
    const bool kb = ys_in && xs_b && mb &&
                    nms(cb_, ra[j - 2], rb[j - 2], mr, ca_, cr, ra[j], rb[j], pr);
    const bool wr = writes && y_in;
    float* out = sup + o;
    if (EVEN) {
      if (wr && ca < w) *reinterpret_cast<float2*>(out) = make_float2(ka ? ca_ : kNeg, kb ? cb_ : kNeg);
    } else {
      if (wr && ca < w) out[0] = ka ? ca_ : kNeg;
      if (wr && cb < w) out[1] = kb ? cb_ : kNeg;
    }
    // queue the survivor (NMS keeps at most one of two neighbours)
    const bool kk = ka || kb;
    const unsigned bal = __ballot_sync(kFull, kk);
    if (kk) {
      Cand& q = s_queue[wid][queued + __popc(bal & ((1u << lane) - 1u))];
      q.o = ka ? o : o + 1;
      q.c = ka ? ca_ : cb_;
      q.l = ka ? cl : ca_;
      q.r = ka ? cb_ : cr;
      q.u = ka ? ra[j - 2] : rb[j - 2];
      q.d = ka ? ra[j] : rb[j];
    }
    queued += __popc(bal);
  }

  // the subpixel fits of the queued survivors, a lane each; border >= 1
  // puts each fit's clamped centre on its survivor
  __syncwarp();
  for (int e = lane; e < queued; e += 32) {
    const Cand q = s_queue[wid][e];
    off[q.o] = make_float2(fit(q.l, q.c, q.r), fit(q.u, q.c, q.d));
    run_max = fmaxf(run_max, q.c);
  }

  // the CTA's max of sup; the last CTA to finish reduces them into floor
  run_max = warp_max(run_max);
  if (lane == 0) s_max[wid] = run_max;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = s_max[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) m = fmaxf(m, s_max[i]);
    cta_max[blockIdx.x] = m;
    __threadfence();
    s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float m = kNeg;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) m = fmaxf(m, __ldcg(cta_max + i));
  m = warp_max(m);
  if (lane == 0) s_max[wid] = m;   // thread 0 read s_max before the barrier above
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) m = fmaxf(m, s_max[i]);
    floor_out[0] = threshold * fmaxf(m, 1e-20f);
    *counter = 0u;
  }
}

}  // namespace

// img (h, w) fp32; mask (h, w) bytes or null; sup (h, w) fp32; off (h, w, 2)
// fp32; cta_max ceil(ceil(w / 56) * ceil(h / 8) / 4) floats of scratch;
// counter one unsigned that is 0 on entry and 0 again when the kernel ends;
// floor_out one float. border >= 1; 2 h w < 2^31 (offsets are 32-bit).
extern "C" int ptz_harris_nms(const void* img, const void* mask, void* sup,
                              void* off, void* cta_max, void* counter,
                              void* floor_out, int h, int w, int border,
                              float threshold, float k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (h < 1 || w < 1 || border < 1 || 2LL * h * w >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int n_strips = (w + kStrip - 1) / kStrip;
  const int n_runs = (h + kRun - 1) / kRun;
  const int ctas = (n_strips * n_runs + kWarps - 1) / kWarps;
  const auto kernel = w % 2 == 0 ? detect_kernel<true> : detect_kernel<false>;
  kernel<<<ctas, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const unsigned char*)mask, (float*)sup, (float2*)off, (float*)cta_max,
      (unsigned*)counter, (float*)floor_out, h, w, border, n_strips, n_runs, threshold, k, 0);
  return (int)cudaGetLastError();
}

extern "C" const char* ptz_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
