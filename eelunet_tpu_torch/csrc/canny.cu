// Fused Canny stencil for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel _canny_kernel of
// eelunet_tpu/ops/edge_pallas.py:70, launched by fused_canny (:144 -> :178).
// Per pixel of an (N, H, W) float32 image, all in float32:
//   blur   separable 5-tap Gaussian g (rows, then columns), zero padding;
//   Sobel  dx = b[j+1] - b[j-1], gx = dx[i-1] + 2 dx[i] + dx[i+1], and gy
//          likewise across the other axis;
//   NMS    keep a pixel that is >= both neighbours along its gradient
//          direction, neighbours outside the image 0.
// Two modes (the wrapper is eelunet_tpu_torch/ops/edge_cuda.py):
//   0 "zero"    _canny_kernel exactly: Sobel on the zero-padded blur,
//               directions from |gy| vs tan(22.5 deg)|gx| and tan(67.5 deg)|gx|
//               with the sign of gx*gy, comparisons on mag^2;
//               out = keep & (mag^2 >= low^2) as 1.0 / 0.0.
//   1 "improve" the stencil stage of ops/edge.canny_edge_improve: Sobel on
//               the blur reflect-padded by one pixel (row -1 reads row 1),
//               mag = sqrt(gx^2 + gy^2), the direction from
//               atan2(gy, gx + 1e-6) in degrees as non_max_suppression
//               buckets it, comparisons on mag; out = mag * keep.
//
// What bounds it on an H100: at the training path's site, (8, 512, 512)
// float32, it reads 8.4 MB and writes 8.4 MB (5 us at 3.35 TB/s) and does
// about 60 flops per pixel (2 us at 67 TFLOP/s in f32): bytes bound it, and
// at that size the launch itself is a large share of the time. So the
// design is simple:
//   - one block per 32 x 16 tile of output pixels; the tile's input plus a
//     4-pixel halo on all sides (2 blur + 1 Sobel + 1 NMS) is staged in
//     shared memory, zero outside the image, so the image is read once
//     (with a 1.9x halo overhead) and written once;
//   - each stage (vertical blur, horizontal blur, Sobel + magnitude, NMS)
//     runs over the region of the tile the next stage reads, in shared
//     memory, 256 threads striding over it;
//   - halos that cross a tile edge read the neighbour tile's real pixels;
//     every blurred value and every gradient outside the image is zero on
//     rows and columns alike, which is the per-stage zero padding of the
//     reference (the Pallas kernel masks rows only: its columns are whole).
// Products and sums use the _rn intrinsics: no FMA contraction, so each
// value rounds where the plain twin (fused_canny_reference) rounds it.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// stream it is given and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;         // output tile width
constexpr int kTH = 16;         // output tile height
constexpr int kHalo = 4;        // blur 2 + Sobel 1 + NMS 1
constexpr int kThreads = 256;
constexpr int kXW = kTW + 2 * kHalo, kXH = kTH + 2 * kHalo;  // input, rows/cols [-4, T+4)
constexpr int kBW = kTW + 4, kBH = kTH + 4;                  // blur, [-2, T+2)
constexpr int kGW = kTW + 2, kGH = kTH + 2;                  // gradients, [-1, T+1)
constexpr float kTan22 = 0.41421356237309503f;   // float32(tan(22.5 deg))
constexpr float kTan67 = 2.4142135623730949f;    // float32(tan(67.5 deg))
constexpr float kDeg = 57.295779513082323f;      // float32(180 / pi)
constexpr float kAngleEps = 1e-6f;

struct Taps {
  float g[5];
};

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// grid (ceil(W / kTW), ceil(H / kTH), N); x, out (N, H, W) float32.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
canny_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, Taps t,
             float low2) {
  __shared__ float sx[kXH][kXW];
  __shared__ float st[kBH][kXW];   // vertical pass: rows [-2, T+2), cols [-4, T+4)
  __shared__ float sb[kBH][kBW];
  __shared__ float sgx[kGH][kGW];
  __shared__ float sgy[kGH][kGW];
  __shared__ float sm[kGH][kGW];   // mag^2 (zero) or mag (improve)

  const int c0 = blockIdx.x * kTW, r0 = blockIdx.y * kTH;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W;
  const float* xi = x + img;
  const int tid = threadIdx.x;

  for (int k = tid; k < kXH * kXW; k += kThreads) {
    const int r = k / kXW, c = k - r * kXW;
    const int gr = r0 + r - kHalo, gc = c0 + c - kHalo;
    sx[r][c] = (gr >= 0 && gr < H && gc >= 0 && gc < W) ? xi[static_cast<size_t>(gr) * W + gc]
                                                        : 0.f;
  }
  __syncthreads();

  // Vertical 5-tap pass: st row r is image row r0 + r - 2, from sx rows r..r+4.
  for (int k = tid; k < kBH * kXW; k += kThreads) {
    const int r = k / kXW, c = k - r * kXW;
    float v = __fmul_rn(t.g[0], sx[r][c]);
#pragma unroll
    for (int d = 1; d < 5; ++d) v = __fadd_rn(v, __fmul_rn(t.g[d], sx[r + d][c]));
    st[r][c] = v;
  }
  __syncthreads();

  // Horizontal pass; the blur is zero outside the image.
  for (int k = tid; k < kBH * kBW; k += kThreads) {
    const int r = k / kBW, c = k - r * kBW;
    const int gr = r0 + r - 2, gc = c0 + c - 2;
    float v = __fmul_rn(t.g[0], st[r][c]);
#pragma unroll
    for (int d = 1; d < 5; ++d) v = __fadd_rn(v, __fmul_rn(t.g[d], st[r][c + d]));
    sb[r][c] = (gr >= 0 && gr < H && gc >= 0 && gc < W) ? v : 0.f;
  }
  __syncthreads();

  // Sobel and magnitude; gradients outside the image are zero.
  for (int k = tid; k < kGH * kGW; k += kThreads) {
    const int r = k / kGW, c = k - r * kGW;
    const int gr = r0 + r - 1, gc = c0 + c - 1;
    float gx = 0.f, gy = 0.f, m = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      // b(dr, dc): the blur at image (gr + dr, gc + dc), |dr|, |dc| <= 1;
      // zero mode reads the zeros stored outside the image, improve mode
      // reflects the index back inside it.
      auto b = [&](int dr, int dc) {
        int rr = gr + dr, cc = gc + dc;
        if (kMode == 1) {
          rr = reflect(rr, H);
          cc = reflect(cc, W);
        }
        return sb[rr - r0 + 2][cc - c0 + 2];
      };
      const float dxm = __fsub_rn(b(-1, 1), b(-1, -1));
      const float dx0 = __fsub_rn(b(0, 1), b(0, -1));
      const float dxp = __fsub_rn(b(1, 1), b(1, -1));
      const float dym = __fsub_rn(b(1, -1), b(-1, -1));
      const float dy0 = __fsub_rn(b(1, 0), b(-1, 0));
      const float dyp = __fsub_rn(b(1, 1), b(-1, 1));
      gx = __fadd_rn(__fadd_rn(dxm, __fmul_rn(2.f, dx0)), dxp);
      gy = __fadd_rn(__fadd_rn(dym, __fmul_rn(2.f, dy0)), dyp);
      m = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
      if (kMode == 1) m = sqrtf(m);
    }
    sgx[r][c] = gx;
    sgy[r][c] = gy;
    sm[r][c] = m;
  }
  __syncthreads();

  // Non-max suppression over the output tile.
  float* oi = out + img;
  for (int k = tid; k < kTH * kTW; k += kThreads) {
    const int r = k / kTW, c = k - r * kTW;
    const int gr = r0 + r, gc = c0 + c;
    if (gr >= H || gc >= W) continue;
    const int i = r + 1, j = c + 1;  // in the gradient arrays
    const float gx = sgx[i][j], gy = sgy[i][j], m = sm[i][j];
    bool b0, b45, b90, b135;
    if (kMode == 0) {
      const float ax = fabsf(gx), ay = fabsf(gy);
      b0 = ay < __fmul_rn(kTan22, ax);
      b90 = ay >= __fmul_rn(kTan67, ax);
      const bool same = __fmul_rn(gx, gy) > 0.f;
      b45 = !b0 && !b90 && same;
      b135 = !b0 && !b90 && !same;
    } else {
      float a = __fmul_rn(atan2f(gy, __fadd_rn(gx, kAngleEps)), kDeg);
      if (a < 0.f) a = __fadd_rn(a, 180.f);
      // non_max_suppression takes a mod 180 first; that only maps
      // [180, 360) into bucket 0, which a >= 157.5 already selects.
      b0 = a < 22.5f || a >= 157.5f;
      b45 = a >= 22.5f && a < 67.5f;
      b90 = a >= 67.5f && a < 112.5f;
      b135 = a >= 112.5f && a < 157.5f;
    }
    const bool keep = (b0 && m >= sm[i][j - 1] && m >= sm[i][j + 1]) ||
                      (b45 && m >= sm[i - 1][j + 1] && m >= sm[i + 1][j - 1]) ||
                      (b90 && m >= sm[i - 1][j] && m >= sm[i + 1][j]) ||
                      (b135 && m >= sm[i - 1][j - 1] && m >= sm[i + 1][j + 1]);
    const size_t at = static_cast<size_t>(gr) * W + gc;
    if (kMode == 0) {
      oi[at] = (keep && m >= low2) ? 1.f : 0.f;
    } else {
      oi[at] = __fmul_rn(m, keep ? 1.f : 0.f);
    }
  }
}

}  // namespace

// mode: 0 = zero, 1 = improve. x, out: (N, H, W) float32, contiguous.
// g0..g4: the separable Gaussian taps; low2: the squared low threshold
// (mode 0 only).
extern "C" int eelunet_fused_canny(int mode, const void* x, void* out, int N, int H, int W,
                                   float g0, float g1, float g2, float g3, float g4,
                                   float low2, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || N > 65535) return cudaErrorInvalidValue;
  if (mode == 1 && (H < 2 || W < 2)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, N);
  const Taps t = {{g0, g1, g2, g3, g4}};
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  if (mode == 0) {
    canny_kernel<0><<<grid, kThreads, 0, s>>>(xp, op, H, W, t, low2);
  } else if (mode == 1) {
    canny_kernel<1><<<grid, kThreads, 0, s>>>(xp, op, H, W, t, low2);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
