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
// rest as some 250 small torch kernels a call, each a round trip through
// device memory and ~25 us of host issue. Here a CTA of 256 threads owns a
// keypoint from the window to the last normalization:
//   - the window (side 47 with a scale, 19 without) lands in shared memory
//     from the unpadded image with clamped row and column indices, a row at
//     a time with neighbouring threads on neighbouring addresses: the plain
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
//   - a thread a patch pixel forms its gradient, magnitude and orientation
//     bins; a thread a histogram bin then sums over the 256 pixels in index
//     order (no atomics: repeated calls are bitwise equal), the spatial
//     weights read from the cached table the plain version uses;
//   - L2, the 0.2 clip and L2 again are warp-shuffle butterflies over the
//     128 bins, combined in a fixed order.
// Clamps propagate NaN as torch.clamp does, so a valid row whose position
// is NaN comes out NaN as on the plain route; an invalid row is zeros.
//
// What bounds it: bytes. At the bench shape (512 keypoints on a 720p
// frame, with a scale) the pixels the windows cover, read once, and the
// 256 KB of output are 2.6 MB, 0.78 us at 3.35 TB/s; its 17 MFLOP of
// necessary work is 0.25 us at the fp32 peak. The per-bin loop runs over
// all 256 pixels, where ~64 carry a nonzero spatial weight, so the kernel
// does several times that work: a simple, correct first design, 512 CTAs
// of 33 KB of shared memory, about one wave. On an H100 SXM (700 W) it
// takes 0.019 ms, 4% of the bound.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPatch = 16;                  // descriptor.PATCH
constexpr int kPix = kPatch * kPatch;       // patch pixels
constexpr int kSub = kPatch + 2;            // the aligned sample grid's side
constexpr int kCells = 4;                   // descriptor.CELLS
constexpr int kBins = 8;                    // descriptor.ORI_BINS
constexpr int kCellCount = kCells * kCells;
constexpr int kDim = kCellCount * kBins;    // descriptor.DESC_DIM
constexpr int kScaledWin = 46;              // descriptor.SCALED_WIN
constexpr int kMaxSide = kScaledWin + 1;    // the scaled route's window side
constexpr int kThreads = kPix;              // a thread a patch pixel
constexpr unsigned kFull = 0xffffffffu;

static_assert(kDim % 32 == 0 && kDim <= kThreads, "a thread a bin, whole warps");

struct Smem {
  float win[kMaxSide * kMaxSide];   // the window, side win + 1
  float rows[kSub * kScaledWin];    // the blend resampled along y (scaled route)
  float sub[kSub * kSub];           // the aligned samples
  float spatial[kPix * kCellCount]; // descriptor._spatial_weights
  float mag[kPix];
  float fb[kPix];
  int bin[kPix];                    // the lower orientation bin
  int tap[kSub];                    // the resample's first tap
  float w0[kSub], w1[kSub];         // and its two weights
  float part[kDim / 32];            // per-warp sums of squares
};

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

// L2 norm of a bin value over the CTA's 128 bin threads, clamped below at
// 1e-9 (vector_norm(...).clamp_min(1e-9)); every thread calls it.
__device__ __forceinline__ float norm128(float v, bool bin_thread, float* part) {
  const int t = threadIdx.x;
  const float ss = warp_sum(bin_thread ? __fmul_rn(v, v) : 0.f);
  if (bin_thread && (t & 31) == 0) part[t >> 5] = ss;
  __syncthreads();
  float tot = part[0];
#pragma unroll
  for (int i = 1; i < kDim / 32; ++i) tot = __fadd_rn(tot, part[i]);
  __syncthreads();   // part is written again by the next call
  const float n = sqrtf(tot);
  return isnan(n) ? n : fmaxf(n, 1e-9f);
}

__global__ void __launch_bounds__(kThreads)
    describe_kernel(const float* __restrict__ img, int h, int w, const float* __restrict__ xy,
                    const unsigned char* __restrict__ valid, const float* __restrict__ scale,
                    const float* __restrict__ spatial, float* __restrict__ out) {
  __shared__ Smem sm;
  const int k = blockIdx.x, t = threadIdx.x;
  float* dst = out + (size_t)k * kDim;
  if (!valid[k]) {   // the whole CTA leaves together
    if (t < kDim) dst[t] = 0.f;
    return;
  }
  const bool scaled = scale != nullptr;
  const int win = scaled ? kScaledWin : kSub;
  const int side = win + 1, half = win / 2, pad = half + 1;

  // descriptor._window_starts: the window's first row and column in the
  // edge-padded image (clamped as there and as kernel B clamps them), as
  // image coordinates; the fractional offsets
  const float yh = __fadd_rn(xy[2 * k + 1], 0.5f), xh = __fadd_rn(xy[2 * k], 0.5f);
  const int y0 = static_cast<int>(floorf(yh)), x0 = static_cast<int>(floorf(xh));
  const float fy = clamp_t(__fsub_rn(yh, (float)y0), 0.f, 1.f);
  const float fx = clamp_t(__fsub_rn(xh, (float)x0), 0.f, 1.f);
  const int shift = pad - half;   // y0 - half + pad, wrapping like torch's int32
  const int ys = min(max((int)((unsigned)y0 + (unsigned)shift), 0), h + 2 * pad - win - 1);
  const int xs = min(max((int)((unsigned)x0 + (unsigned)shift), 0), w + 2 * pad - win - 1);
  const int top = ys - pad, left = xs - pad;

  for (int i = t; i < side * side; i += kThreads) {
    const int r = i / side, c = i - r * side;
    const int row = min(max(top + r, 0), h - 1), col = min(max(left + c, 0), w - 1);
    sm.win[i] = __ldg(img + (size_t)row * w + col);
  }
  for (int i = t; i < kPix * kCellCount; i += kThreads) sm.spatial[i] = __ldg(spatial + i);
  if (scaled && t < kSub) {
    // descriptor._resample_matrix's row t: its two nonzeros, bit for bit
    const float s = clamp_t(__ldg(scale), 1.f / 2.5f, 2.5f);
    const float pos = __fadd_rn(__fmul_rn(__fsub_rn((float)t, 0.5f * (kSub - 1)), s),
                                0.5f * (kScaledWin - 1));
    const int j0 = min(max(static_cast<int>(floorf(pos)), 0), kScaledWin - 2);
    sm.tap[t] = j0;
    sm.w0[t] = clamp_t(__fsub_rn(1.f, fabsf(__fsub_rn(pos, (float)j0))), 0.f, 1.f);
    sm.w1[t] = clamp_t(__fsub_rn(1.f, fabsf(__fsub_rn(pos, (float)(j0 + 1)))), 0.f, 1.f);
  }
  __syncthreads();

  const float a = __fsub_rn(1.f, fy), b = __fsub_rn(1.f, fx);
  if (scaled) {
    // rows[i][v] = sum_w r[i, w] blend[w, v]: the two taps in index order,
    // as a dot product accumulates (an FMA onto the first product)
    for (int e = t; e < kSub * kScaledWin; e += kThreads) {
      const int i = e / kScaledWin, v = e - i * kScaledWin, j = sm.tap[i];
      const float lo = blend(sm.win, side, j, v, fy, fx, a, b);
      const float hi = blend(sm.win, side, j + 1, v, fy, fx, a, b);
      sm.rows[e] = __fmaf_rn(hi, sm.w1[i], __fmul_rn(lo, sm.w0[i]));
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

  {
    // pixel t: central differences, magnitude, orientation and its bins
    // (descriptor._orientation_bins; the division by 2 pi is torch's on the
    // card, a product with the fp32 reciprocal)
    const int py = t / kPatch, px = t - py * kPatch;
    const float* c = sm.sub + (py + 1) * kSub + px + 1;
    const float gx = __fmul_rn(0.5f, __fsub_rn(c[1], c[-1]));
    const float gy = __fmul_rn(0.5f, __fsub_rn(c[kSub], c[-kSub]));
    const float mag = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), 1e-12f));
    const float ori = atan2f(gy, gx);
    const float inv_2pi = 1.0f / 6.28318530717958647692f;
    const float bf = __fmul_rn(__fadd_rn(__fmul_rn(ori, inv_2pi), 0.5f), (float)kBins);
    const float b0 = floorf(bf);
    const int bi = static_cast<int>(b0) % kBins;   // torch.remainder: the divisor's sign
    sm.mag[t] = mag;
    sm.fb[t] = __fsub_rn(bf, b0);
    sm.bin[t] = bi < 0 ? bi + kBins : bi;
  }
  __syncthreads();

  // bin t = (cell, orientation): hist = sum_p (mag_p spatial_pc) ori_w_po
  // over p in order, ori_w = onehot0 (1 - fb) + onehot1 fb as the plain
  // version forms it (so a NaN fb reaches every bin, as there)
  const bool bin_thread = t < kDim;
  float v = 0.f;
  if (bin_thread) {
    const int cell = t / kBins, o = t - cell * kBins;
    for (int p = 0; p < kPix; ++p) {
      const int b0 = sm.bin[p];
      const float f = sm.fb[p];
      const float on0 = b0 == o ? 1.f : 0.f;
      const float on1 = (b0 + 1) % kBins == o ? 1.f : 0.f;
      const float ow = __fadd_rn(__fmul_rn(on0, __fsub_rn(1.f, f)), __fmul_rn(on1, f));
      v = __fmaf_rn(__fmul_rn(sm.mag[p], sm.spatial[p * kCellCount + cell]), ow, v);
    }
  }
  // SIFT normalization: L2, clip at 0.2, L2 (torch.clamp_max passes NaN)
  v = __fdiv_rn(v, norm128(v, bin_thread, sm.part));
  v = isnan(v) ? v : fminf(v, 0.2f);
  v = __fdiv_rn(v, norm128(v, bin_thread, sm.part));
  if (bin_thread) dst[t] = v;
}

}  // namespace

extern "C" int ptz_describe(const void* img, int h, int w, const void* xy, const void* valid,
                            const void* scale, const void* spatial, void* out, int num,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (h < 1 || w < 1 || num < 0) return (int)cudaErrorInvalidValue;
  if (num == 0) return (int)cudaSuccess;
  describe_kernel<<<num, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, h, w, (const float*)xy, (const unsigned char*)valid,
      (const float*)scale, (const float*)spatial, (float*)out);
  return (int)cudaGetLastError();
}
