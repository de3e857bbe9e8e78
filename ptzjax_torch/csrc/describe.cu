// Upright-SIFT descriptors for Hopper (sm_90a), kernel F: all of
// ptzjax_torch/kernels/descriptor.py:describe_keypoints for one keypoint in
// one CTA, the whole table in one launch.
//
// Replaces, at its descriptor call site, the TPU kernel
// ptzjax/kernels/window_pallas.py:gather_windows_pallas (called from
// ptzjax/kernels/descriptor.py:_extract_aligned), together with the rest of
// that file's describe_keypoints, which XLA runs next to the windows as one
// jitted program: the 4-shift blend, the separable resample, the gradients,
// the soft orientation binning, the histogram einsum and L2 / clip / L2.
// The port's first design kept the gather as its own kernel (B) and ran the
// rest as some 250 small torch kernels a call. Here a CTA of 128 threads
// (four warps) owns a keypoint from the window to the last normalization:
//   - only the window pixels the descriptor reads land in shared memory:
//     with a scale, the rows (and the same columns) that the resample's 18
//     tap pairs read through the 2 x 2 blend (20 of the 47 at unit spacing,
//     9 at 1/2.5, 45 at 2.5), compacted; without one, the 19 x 19 window.
//     They are copied (cp.async, all in flight at once) from the unpadded
//     image at clamped row and column indices, neighbouring threads on
//     neighbouring columns: the plain
//     version's edge-padded copy (descriptor._window_starts) is addressing,
//     and no padded image is written;
//   - the window start, the fractional offsets and the resample taps are
//     the plain version's arithmetic, each operation rounded once (the file
//     is built with -fmad=false); float-to-int conversions saturate as
//     torch's do on the card and the start's int32 sum wraps as torch's
//     does, so a far-off position lands at the plain route's edge;
//   - the resample is the dense (18, 46) matrix product written as what it
//     is, 2 taps a sample (the matrix's only nonzeros, the same bits), along
//     y and then along x, the blend computed at the rows the y taps read;
//   - a thread forms two patch pixels' gradient, magnitude, Gaussian weight
//     and orientation bins; a thread a histogram bin (cell, orientation)
//     then sums over the pixels where its cell's spatial weight is nonzero
//     (a 6-8 x 6-8 rectangle of the 16 x 16 patch: 784 of the table's 4,096
//     entries), in index order, only the terms of pixels one of whose two
//     orientation bins is its own: the plain version's other terms are
//     exact zeros, whose sum leaves a finite sum's bits as they are. No
//     table is read: each term's spatial weight is the table's formula
//     computed in registers (the row's and the column's bilinear weights,
//     the pixel's Gaussian factor), its products associated otherwise than
//     the table's (mag x gauss first), a rounding apart. A non-finite
//     magnitude or orientation weight anywhere in the patch makes every bin
//     NaN through a CTA-wide flag, as 0 x NaN and inf x 0 do in the plain
//     einsum. No atomics: repeated calls are bitwise equal;
//   - L2, the 0.2 clip and L2 again are warp-shuffle butterflies over the
//     128 bins, combined in a fixed order.
// Clamps propagate NaN as torch.clamp does, so a valid row whose position
// is NaN comes out NaN as on the plain route; an invalid row is zeros.
// 512 keypoints are 512 CTAs of 17,984 B of static shared memory, ~4 a SM.
//
// What bounds it (chip_smoke.py: describe_work): bytes. At the bench shape
// (512 keypoints on a 720p frame, 508 valid, scale 1.0) the pixels the
// descriptors depend on, read once, and the 256 KB of output are 0.862 MB,
// 0.26 us at 3.35 TB/s; its 8.4 MFLOP of necessary work is 0.13 us at the
// fp32 peak. On an H100 SXM (700 W) it takes 0.0088 ms, 2.9% of the bound
// (0.0078 ms without a scale): every CTA is resident at once, so a CTA's
// chain of phases sets the time, a third of it the histogram's 48-64
// terms a bin (PERF.md).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPatch = 16;                  // descriptor.PATCH
constexpr int kPix = kPatch * kPatch;       // patch pixels
constexpr int kSub = kPatch + 2;            // the aligned sample grid's side
constexpr int kCells = 4;                   // descriptor.CELLS
constexpr int kBins = 8;                    // descriptor.ORI_BINS
constexpr int kDim = kCells * kCells * kBins;   // descriptor.DESC_DIM
constexpr int kScaledWin = 46;              // descriptor.SCALED_WIN
constexpr int kMaxSide = kScaledWin + 1;    // the scaled route's window side
constexpr int kThreads = kDim;              // a thread a bin
constexpr int kWarps = kThreads / 32;
constexpr int kNonzero = 784;               // the spatial table's nonzeros
constexpr unsigned kFull = 0xffffffffu;

static_assert(kPix % kThreads == 0 && kMaxSide <= 64, "two pixels a thread; a window row a lane");

// Where descriptor._spatial_weights is nonzero for cell (cy, cx): the
// rectangle of patch rows cell_lo(cy)..cell_hi(cy) and columns
// cell_lo(cx)..cell_hi(cx), where the bilinear cell weight is positive.
__host__ __device__ constexpr int cell_lo(int c) { return 4 * c - 2 < 0 ? 0 : 4 * c - 2; }
__host__ __device__ constexpr int cell_hi(int c) { return 4 * c + 5 > kPatch - 1 ? kPatch - 1 : 4 * c + 5; }
__host__ __device__ constexpr int cell_side(int c) { return cell_hi(c) - cell_lo(c) + 1; }
constexpr int kMaxCellSide = cell_side(1);   // 8

static_assert(cell_side(0) + cell_side(1) + cell_side(2) + cell_side(3) == 28 && 28 * 28 == kNonzero,
              "the rectangles hold the table's nonzeros");
static_assert(cell_side(0) <= kMaxCellSide && cell_side(3) <= kMaxCellSide, "8 x 8 at most");

struct Smem {
  float win[kMaxSide * kMaxSide];   // the window's needed rows x columns, compacted
  float rows[kSub * kScaledWin];    // the blend resampled along y (scaled route)
  float sub[kSub * kSub];           // the aligned samples
  float4 px[kPix];                  // a pixel's magnitude x Gaussian weight, 1 - fb, fb and lower bin (as bits)
  int at[kMaxSide];                 // the window row (and column) of each compacted one
  int tap[kSub];                    // the resample's first tap, compacted
  float w0[kSub], w1[kSub];         // and its two weights
  float part[kWarps];               // per-warp sums of squares
  int side;                         // the compacted window's side
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// The sum over a warp, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One window sample of descriptor._blend at window (r, c) of a side-wide
// window: ((p00 a) b + (p01 a) fx) + (p10 fy) b) + (p11 fy) fx, with
// a = 1 - fy, b = 1 - fx, in torch's order.
__device__ __forceinline__ float blend(const float* win, int side, int r, int c, float fy,
                                       float fx, float a, float b) {
  const float* p = win + r * side + c;
  float v = __fmul_rn(__fmul_rn(p[0], a), b);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(p[1], a), fx));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(p[side], fy), b));
  return __fadd_rn(v, __fmul_rn(__fmul_rn(p[side + 1], fy), fx));
}

// The bilinear weight of patch row (or column) p for cell row (or column)
// c: descriptor._spatial_weights' clamp(1 - |((p - 7.5) + 8) / 4 - 0.5 - c|,
// 0, 1).
__device__ __forceinline__ float cell_weight(int p, float c) {
  const float at = __fsub_rn(__fmul_rn(__fadd_rn(__fsub_rn((float)p, 7.5f), 8.f), 0.25f), 0.5f);
  return fminf(fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(at, c))), 0.f), 1.f);
}

// L2 norm of the CTA's 128 bin values (a bin a thread), clamped below at
// 1e-9 (vector_norm(...).clamp_min(1e-9)); every thread calls it.
__device__ __forceinline__ float norm128(float v, float* part) {
  const int t = threadIdx.x;
  const float ss = warp_sum(__fmul_rn(v, v));
  if ((t & 31) == 0) part[t >> 5] = ss;
  __syncthreads();
  float tot = part[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) tot = __fadd_rn(tot, part[i]);
  __syncthreads();   // part is written again by the next call
  const float n = sqrtf(tot);
  return isnan(n) ? n : fmaxf(n, 1e-9f);
}

__global__ void __launch_bounds__(kThreads)
    describe_kernel(const float* __restrict__ img, int h, int w, const float* __restrict__ xy,
                    const unsigned char* __restrict__ valid, const float* __restrict__ scale,
                    float* __restrict__ out) {
  __shared__ Smem sm;
  const int k = blockIdx.x, t = threadIdx.x;
  float* dst = out + (size_t)k * kDim;
  const bool scaled = scale != nullptr;
  // the row's flag, position and the scale, all in flight together
  const bool row_valid = valid[k] != 0;
  const float x_in = xy[2 * k], y_in = xy[2 * k + 1];
  const float s_in = scaled ? __ldg(scale) : 1.f;
  if (!row_valid) {   // the whole CTA leaves together
    dst[t] = 0.f;
    return;
  }
  const int win = scaled ? kScaledWin : kSub;
  const int half = win / 2, pad = half + 1;

  // descriptor._window_starts: the window's first row and column in the
  // edge-padded image (clamped as there and as kernel B clamps them), as
  // image coordinates; the fractional offsets
  const float yh = __fadd_rn(y_in, 0.5f), xh = __fadd_rn(x_in, 0.5f);
  const int y0 = static_cast<int>(floorf(yh)), x0 = static_cast<int>(floorf(xh));
  const float fy = clamp_t(__fsub_rn(yh, (float)y0), 0.f, 1.f);
  const float fx = clamp_t(__fsub_rn(xh, (float)x0), 0.f, 1.f);
  const int shift = pad - half;   // y0 - half + pad, wrapping like torch's int32
  const int ys = min(max((int)((unsigned)y0 + (unsigned)shift), 0), h + 2 * pad - win - 1);
  const int xs = min(max((int)((unsigned)x0 + (unsigned)shift), 0), w + 2 * pad - win - 1);
  const int top = ys - pad, left = xs - pad;

  if (t < 32) {
    // warp 0: the resample's taps (descriptor._resample_matrix's row i: its
    // two nonzeros, bit for bit), and the window rows they read through the
    // blend, compacted: row r is kept if r - 2 <= j0(i) <= r for some i
    const int lane = t;
    int j0 = 0;
    if (scaled && lane < kSub) {
      const float s = clamp_t(s_in, 1.f / 2.5f, 2.5f);
      const float pos = __fadd_rn(__fmul_rn(__fsub_rn((float)lane, 0.5f * (kSub - 1)), s),
                                  0.5f * (kScaledWin - 1));
      j0 = min(max(static_cast<int>(floorf(pos)), 0), kScaledWin - 2);
      sm.w0[lane] = clamp_t(__fsub_rn(1.f, fabsf(__fsub_rn(pos, (float)j0))), 0.f, 1.f);
      sm.w1[lane] = clamp_t(__fsub_rn(1.f, fabsf(__fsub_rn(pos, (float)(j0 + 1)))), 0.f, 1.f);
    }
    // row r is kept where a tap's rows j0 .. j0 + 2 hold it: those bits of
    // each lane, OR-ed over the warp (without a scale, rows 0 .. 18)
    const unsigned long long rows = scaled && lane < kSub ? 7ull << j0 : 0ull;
    const unsigned m0 = scaled ? __reduce_or_sync(kFull, (unsigned)rows) : (2u << win) - 1u;
    const unsigned m1 = scaled ? __reduce_or_sync(kFull, (unsigned)(rows >> 32)) : 0u;
    const bool keep[2] = {((m0 >> lane) & 1u) != 0, ((m1 >> lane) & 1u) != 0};
    const unsigned below = (1u << lane) - 1u;
    const int c0 = __popc(m0 & below), c1 = __popc(m0) + __popc(m1 & below);
    if (keep[0]) sm.at[c0] = lane;
    if (keep[1]) sm.at[c1] = lane + 32;
    if (lane == 0) sm.side = __popc(m0) + __popc(m1);
    // the first tap's compacted index: the kept rows below it
    if (scaled && lane < kSub)
      sm.tap[lane] = j0 < 32 ? __popc(m0 & ((1u << j0) - 1u)) : __popc(m0) + __popc(m1 & ((1u << (j0 - 32)) - 1u));
  }
  __syncthreads();

  // the window: every copy in flight at once (cp.async), a warp a row, a
  // lane a column
  const int side = sm.side, lane = t & 31, warp = t >> 5;
  for (int r = warp; r < side; r += kWarps) {
    const float* src = img + (size_t)min(max(top + sm.at[r], 0), h - 1) * w;
    for (int c = lane; c < side; c += 32) cp_async4(sm.win + r * side + c, src + min(max(left + sm.at[c], 0), w - 1));
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const float a = __fsub_rn(1.f, fy), b = __fsub_rn(1.f, fx);
  if (scaled) {
    // rows[i][v] = sum_w r[i, w] blend[w, v]: the two taps in index order,
    // as a dot product accumulates (an FMA onto the first product), at every
    // compacted column but the last (a blend there would read past it); the
    // blend at compacted (j, v) is the window's at (at[j], at[v]) wherever
    // the resample reads it, since the next kept row is then at[j] + 1
    for (int i = warp; i < kSub; i += kWarps) {   // a warp a row, a lane a column
      const int j = sm.tap[i];
      const float w0 = sm.w0[i], w1 = sm.w1[i];
      for (int v = lane; v < side - 1; v += 32) {
        const float lo = blend(sm.win, side, j, v, fy, fx, a, b);
        const float hi = blend(sm.win, side, j + 1, v, fy, fx, a, b);
        sm.rows[i * kScaledWin + v] = __fmaf_rn(hi, w1, __fmul_rn(lo, w0));
      }
    }
    __syncthreads();
    // sub[i][j] = sum_v rows[i, v] r[j, v]
    for (int e = t; e < kSub * kSub; e += kThreads) {
      const int i = e / kSub, j = e - i * kSub;
      const float* row = sm.rows + i * kScaledWin + sm.tap[j];
      sm.sub[e] = __fmaf_rn(row[1], sm.w1[j], __fmul_rn(row[0], sm.w0[j]));
    }
  } else {
    for (int e = t; e < kSub * kSub; e += kThreads) {
      const int i = e / kSub, j = e - i * kSub;
      sm.sub[e] = blend(sm.win, side, i, j, fy, fx, a, b);
    }
  }
  __syncthreads();

  // pixels t and t + 128: central differences, magnitude, orientation and
  // its bins (descriptor._orientation_bins; the division by 2 pi is torch's
  // on the card, a product with the fp32 reciprocal)
  int bad = 0;
#pragma unroll
  for (int q = 0; q < kPix / kThreads; ++q) {
    const int p = t + kThreads * q;
    const int py = p / kPatch, px = p - py * kPatch;
    const float* c = sm.sub + (py + 1) * kSub + px + 1;
    const float gx = __fmul_rn(0.5f, __fsub_rn(c[1], c[-1]));
    const float gy = __fmul_rn(0.5f, __fsub_rn(c[kSub], c[-kSub]));
    const float mag = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), 1e-12f));
    const float ori = atan2f(gy, gx);
    const float inv_2pi = 1.0f / 6.28318530717958647692f;
    const float bf = __fmul_rn(__fadd_rn(__fmul_rn(ori, inv_2pi), 0.5f), (float)kBins);
    const float b0 = floorf(bf);
    const int bi = static_cast<int>(b0) % kBins;   // torch.remainder: the divisor's sign
    const float f = __fsub_rn(bf, b0);
    // the spatial table's Gaussian factor at this pixel, as it forms it:
    // exp(-(dx^2 + dy^2) / (2 sigma^2)), sigma = 8
    const float dy = __fsub_rn((float)py, 7.5f), dx = __fsub_rn((float)px, 7.5f);
    const float gauss = expf(__fdiv_rn(-__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), 128.f));
    sm.px[p] = make_float4(__fmul_rn(mag, gauss), __fsub_rn(1.f, f), f, __int_as_float(bi < 0 ? bi + kBins : bi));
    bad |= !(isfinite(mag) && isfinite(f));
  }
  bad = __syncthreads_or(bad);

  // bin t = (cell, orientation): hist = sum_p (mag_p spatial_pc) ori_w_po
  // over the cell's rectangle in order, where ori_w_po is 1 - fb on the
  // pixel's lower bin, fb on the next one and 0 elsewhere, and spatial_pc
  // the Gaussian factor (with the magnitude) times the row's and the
  // column's bilinear weights, computed here; a warp's cells share their
  // rows, a row's columns unrolled
  const int cell = t / kBins, o = t - cell * kBins, cy = cell / kCells, cx = cell - cy * kCells;
  const int q0 = cell_lo(cx), nq = cell_side(cx);
  float wx[kMaxCellSide];
#pragma unroll
  for (int q = 0; q < kMaxCellSide; ++q) wx[q] = cell_weight(q0 + q, (float)cx);
  float v = 0.f;
  for (int r = cell_lo(cy); r <= cell_hi(cy); ++r) {
    const float wy = cell_weight(r, (float)cy);
#pragma unroll
    for (int q = 0; q < kMaxCellSide; ++q) {
      if (q < nq) {
        const float4 x = sm.px[r * kPatch + q0 + q];
        const int d = (o - __float_as_int(x.w)) & (kBins - 1);   // 0: the lower bin, 1: the upper
        if (d <= 1) v = __fmaf_rn(__fmul_rn(x.x, __fmul_rn(wy, wx[q])), d ? x.z : x.y, v);
      }
    }
  }
  if (bad) v = __int_as_float(0x7fffffff);   // NaN
  // SIFT normalization: L2, clip at 0.2, L2 (torch.clamp_max passes NaN)
  v = __fdiv_rn(v, norm128(v, sm.part));
  v = isnan(v) ? v : fminf(v, 0.2f);
  v = __fdiv_rn(v, norm128(v, sm.part));
  dst[t] = v;
}

}  // namespace

extern "C" int ptz_describe(const void* img, int h, int w, const void* xy, const void* valid,
                            const void* scale, void* out, int num, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (h < 1 || w < 1 || num < 0) return (int)cudaErrorInvalidValue;
  if (num == 0) return (int)cudaSuccess;
  describe_kernel<<<num, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, h, w, (const float*)xy, (const unsigned char*)valid, (const float*)scale,
      (float*)out);
  return (int)cudaGetLastError();
}
