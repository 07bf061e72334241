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
// about 40 flops per pixel (1.2 us at 67 TFLOP/s in f32): bytes bound it.
// But the image is small and L2-resident in the chain, so what its time
// comes to is the instructions and barriers per pixel. The design keeps
// both few:
//   - one block of 160 threads per 128 x 32 tile of output pixels; each
//     stage runs one thread per column, walking down the rows with its
//     window in registers, so a value is loaded once per stage;
//   - vertical blur: straight from the image (zero outside it) through a
//     5-row window, for the tile's rows and columns plus the halos the
//     later stages read (2 rows, 4 columns each side), into shared memory;
//   - horizontal blur over those rows, zero outside the image;
//   - Sobel on a sliding 3 x 3 window of the blur (mode improve reflects
//     the window's row and column at the image's edge), the magnitude into
//     shared memory (0 outside the image) and each output pixel's direction
//     bucket as a byte; mode improve takes the bucket from the tangent
//     against tan(22.5 deg) and tan(67.5 deg) where the pixel lies more
//     than 0.1% from a bucket edge, and from atan2f, as before, where not,
//     which gives the same bucket as atan2f everywhere;
//   - non-max suppression on a sliding 3 x 3 window of the magnitude.
// Three barriers a tile; 44 KB of shared memory. Measured on an NVIDIA H100
// 80GB HBM3 at 700.00 W (chip_smoke.py phase 3c, CUDA-graph replay, the
// image in L2): 0.0216 ms in mode improve and 0.0166 ms in mode zero at
// (8, 512, 512), against 0.0365 and 0.0294 for the first design (32 x 16
// tiles staged whole, four strided passes).
// Products and sums use the _rn intrinsics: no FMA contraction, so each
// value rounds where the plain twin (fused_canny_reference) rounds it.
//
// The hysteresis behind mode "improve" (hysteresis_kernel) is the CUDA
// counterpart of the lax.while_loop of eelunet_tpu/ops/edge.py:147-186,
// not of a Pallas kernel: from the NMS magnitude m it takes strong = m >=
// high and weak = low <= m < high, grows s |= dilate3x3(s) & weak from
// strong to its fixpoint and writes s as {0, 1} in the caller's type. The
// plain loop (ops/edge_cuda.hysteresis_fixpoint) reads a flag back to the
// host per step; this kernel keeps the fixpoint on the card:
//   - one cooperative launch of persistent blocks (as many as can be
//     resident), which first write a uint8 state per pixel (2 on, 1 weak
//     and not yet reached, 0 off);
//   - then rounds: every block takes its 32 x 32 tiles, loads each with a
//     1-pixel halo from the state (__ldcg: L2, never a stale L1 line),
//     iterates weak -> on where a neighbour is on to a local fixpoint in
//     shared memory, writes the tile back if it changed and raises the
//     round's flag; grid.sync() ends the round, and the loop stops after a
//     round in which nothing changed. The round count goes to a device int
//     that the path never reads.
// Why it is exact: the recurrence is monotone, and its least fixpoint above
// strong is unique, the weak pixels 8-connected to a strong one. Every pixel
// a tile turns on is connected, whatever it read of a neighbour mid-round;
// a round that changes nothing wrote nothing, so every tile saw the same
// state and found it closed. The result therefore equals the plain loop's
// bit for bit, though the step counts differ. What bounds it: a few bytes
// per pixel per round (2 MB of state at (8, 512, 512), in L2), so its time
// is its rounds' barriers and tile loads, not bandwidth: 0.081 ms and 4
// rounds at the Canny path's site (phase 3c, same card), against 5.9 ms
// and 50 steps for the plain loop.
//
// Interface: plain C functions, loaded with ctypes. Each launches on the
// stream it is given and returns cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 128;        // output tile width: one thread per column
constexpr int kTH = 32;         // output tile height
constexpr int kThreads = 160;   // >= the widest stage, kVW
constexpr int kVW = kTW + 8;    // vertical blur: columns [-4, kTW + 4)
constexpr int kVH = kTH + 4;    //                rows [-2, kTH + 2)
constexpr int kBW = kTW + 4;    // horizontal blur: columns [-2, kTW + 2), rows as kVH
constexpr int kMW = kTW + 2;    // gradients: columns [-1, kTW + 1)
constexpr int kMH = kTH + 2;    //            rows [-1, kTH + 1)
constexpr int kPitch = kVW + 4; // floats per staged row
constexpr float kTan22 = 0.41421356237309503f;   // float32(tan(22.5 deg))
constexpr float kTan67 = 2.4142135623730949f;    // float32(tan(67.5 deg))
constexpr float kDeg = 57.295779513082323f;      // float32(180 / pi)
constexpr float kAngleEps = 1e-6f;
constexpr float kEdge = 1e-3f;                   // "near a bucket edge": within 0.1%
enum Bucket : unsigned char { k0 = 0, k45 = 1, k90 = 2, k135 = 3, kNone = 4 };

struct Taps {
  float g[5];
};

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// g0 a0 + g1 a1 + ... + g4 a4, left to right, each product and sum rounded.
__device__ __forceinline__ float tap5(const Taps& t, float a0, float a1, float a2, float a3,
                                      float a4) {
  float v = __fmul_rn(t.g[0], a0);
  v = __fadd_rn(v, __fmul_rn(t.g[1], a1));
  v = __fadd_rn(v, __fmul_rn(t.g[2], a2));
  v = __fadd_rn(v, __fmul_rn(t.g[3], a3));
  return __fadd_rn(v, __fmul_rn(t.g[4], a4));
}

// The direction bucket of mode improve: atan2(gy, gx + 1e-6) in degrees,
// folded into [0, 180), as non_max_suppression buckets it.
__device__ __forceinline__ Bucket bucket_atan2(float gx, float gy) {
  float a = __fmul_rn(atan2f(gy, __fadd_rn(gx, kAngleEps)), kDeg);
  if (a < 0.f) a = __fadd_rn(a, 180.f);
  // non_max_suppression takes a mod 180 first; that only maps [180, 360)
  // into bucket 0, which a >= 157.5 already selects. A NaN is in none.
  if (a < 22.5f || a >= 157.5f) return k0;
  if (a >= 22.5f && a < 67.5f) return k45;
  if (a >= 67.5f && a < 112.5f) return k90;
  return a >= 112.5f && a < 157.5f ? k135 : kNone;
}

// The same bucket without atan2f where |gy| / |gx + 1e-6| lies more than
// kEdge from tan(22.5 deg) and tan(67.5 deg): there the angle is more than
// 0.01 deg from a bucket edge, far past atan2f's error.
__device__ __forceinline__ Bucket bucket_improve(float gx, float gy) {
  const float gxe = __fadd_rn(gx, kAngleEps);
  const float ax = fabsf(gxe), ay = fabsf(gy);
  if (ax >= 1e-30f && ax <= 1e30f && ay <= 1e30f) {
    const float t22 = kTan22 * ax, t67 = kTan67 * ax;
    if (ay < t22 * (1.f - kEdge)) return k0;
    if (ay > t67 * (1.f + kEdge)) return k90;
    if (ay > t22 * (1.f + kEdge) && ay < t67 * (1.f - kEdge))
      return (gy > 0.f) == (gxe > 0.f) ? k45 : k135;
  }
  return bucket_atan2(gx, gy);
}

// The bucket of mode zero: |gy| against tan(22.5 deg)|gx| and
// tan(67.5 deg)|gx|, the sign of gx gy between (_canny_kernel).
__device__ __forceinline__ Bucket bucket_zero(float gx, float gy) {
  const float ax = fabsf(gx), ay = fabsf(gy);
  if (ay < __fmul_rn(kTan22, ax)) return k0;
  if (ay >= __fmul_rn(kTan67, ax)) return k90;
  return __fmul_rn(gx, gy) > 0.f ? k45 : k135;
}

// grid (ceil(W / kTW), ceil(H / kTH), N), kThreads threads; x, out (N, H, W)
// float32.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
canny_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, Taps t,
             float low2) {
  __shared__ float sv[kVH][kPitch];   // vertical blur; later the magnitude
  __shared__ float sb[kVH][kPitch];   // horizontal blur
  __shared__ unsigned char sd[kTH][kTW];  // direction buckets of the output pixels
  float (*sm)[kPitch] = sv;           // magnitude: rows [-1, kTH + 1), columns [-1, kTW + 1)

  const int c0 = blockIdx.x * kTW, r0 = blockIdx.y * kTH;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W;
  const int tid = threadIdx.x;

  // Vertical blur: column c0 - 4 + tid, rows r0 - 2 .. r0 + kTH + 1.
  if (tid < kVW) {
    const int gc = c0 - 4 + tid;
    const bool col = gc >= 0 && gc < W;
    const float* xc = x + img + gc;
    auto ld = [&](int gr) {
      return col && gr >= 0 && gr < H ? __ldg(xc + static_cast<size_t>(gr) * W) : 0.f;
    };
    float w0 = ld(r0 - 4), w1 = ld(r0 - 3), w2 = ld(r0 - 2), w3 = ld(r0 - 1);
#pragma unroll 4
    for (int r = 0; r < kVH; ++r) {
      const float w4 = ld(r0 + r);
      sv[r][tid] = tap5(t, w0, w1, w2, w3, w4);
      w0 = w1;
      w1 = w2;
      w2 = w3;
      w3 = w4;
    }
  }
  __syncthreads();

  // Horizontal blur: column c0 - 2 + tid; zero outside the image.
  if (tid < kBW) {
    const int gc = c0 - 2 + tid;
    const bool col = gc >= 0 && gc < W;
#pragma unroll 4
    for (int r = 0; r < kVH; ++r) {
      const int gr = r0 - 2 + r;
      const float v = tap5(t, sv[r][tid], sv[r][tid + 1], sv[r][tid + 2], sv[r][tid + 3],
                           sv[r][tid + 4]);
      sb[r][tid] = col && gr >= 0 && gr < H ? v : 0.f;
    }
  }
  __syncthreads();

  // Sobel and magnitude: column gc = c0 - 1 + tid, rows r0 - 1 .. r0 + kTH,
  // on a window of the blur's rows p (gr - 1), q (gr), n (gr + 1) at
  // columns l (gc - 1), gc, r (gc + 1); mode improve reflects them at the
  // image's edge. Outside the image the magnitude is 0.
  if (tid < kMW) {
    const int gc = c0 - 1 + tid;
    const bool col = gc >= 0 && gc < W;
    // blur columns, as indices of sb (column c0 - 2 + i)
    const int lc = (kMode == 1 && col ? reflect(gc - 1, W) : gc - 1) - (c0 - 2);
    const int rc = (kMode == 1 && col ? reflect(gc + 1, W) : gc + 1) - (c0 - 2);
    const int cc = tid + 1;
    float p0 = sb[0][lc], p1 = sb[0][cc], p2 = sb[0][rc];
    float q0 = sb[1][lc], q1 = sb[1][cc], q2 = sb[1][rc];
#pragma unroll 2
    for (int r = 0; r < kMH; ++r) {  // magnitude row r is image row r0 - 1 + r, blur row r + 1
      const float n0 = sb[r + 2][lc], n1 = sb[r + 2][cc], n2 = sb[r + 2][rc];
      const int gr = r0 - 1 + r;
      float m = 0.f;
      if (col && gr >= 0 && gr < H) {
        const bool top = kMode == 1 && gr == 0, bottom = kMode == 1 && gr == H - 1;
        const float a0 = top ? n0 : p0, a1 = top ? n1 : p1, a2 = top ? n2 : p2;
        const float b0 = bottom ? p0 : n0, b1 = bottom ? p1 : n1, b2 = bottom ? p2 : n2;
        const float dxm = __fsub_rn(a2, a0);
        const float dx0 = __fsub_rn(q2, q0);
        const float dxp = __fsub_rn(b2, b0);
        const float dym = __fsub_rn(b0, a0);
        const float dy0 = __fsub_rn(b1, a1);
        const float dyp = __fsub_rn(b2, a2);
        const float gx = __fadd_rn(__fadd_rn(dxm, __fmul_rn(2.f, dx0)), dxp);
        const float gy = __fadd_rn(__fadd_rn(dym, __fmul_rn(2.f, dy0)), dyp);
        m = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
        if (kMode == 1) m = sqrtf(m);
        if (r >= 1 && r <= kTH && tid >= 1 && tid <= kTW)
          sd[r - 1][tid - 1] = kMode == 1 ? bucket_improve(gx, gy) : bucket_zero(gx, gy);
      }
      sm[r][tid] = m;
      p0 = q0; p1 = q1; p2 = q2;
      q0 = n0; q1 = n1; q2 = n2;
    }
  }
  __syncthreads();

  // Non-max suppression: output column c0 + tid, on a window of the
  // magnitude (neighbours outside the image are 0).
  if (tid < kTW && c0 + tid < W) {
    const int j = tid + 1;  // the pixel's column in sm
    float* oc = out + img + c0 + tid;
    float p0 = sm[0][j - 1], p1 = sm[0][j], p2 = sm[0][j + 1];
    float q0 = sm[1][j - 1], q1 = sm[1][j], q2 = sm[1][j + 1];
    const int rows = min(kTH, H - r0);
    for (int r = 0; r < rows; ++r) {  // output row r0 + r: magnitude row r + 1
      const float n0 = sm[r + 2][j - 1], n1 = sm[r + 2][j], n2 = sm[r + 2][j + 1];
      const unsigned char d = sd[r][tid];
      const float m = q1;
      const bool keep = (d == k0 && m >= q0 && m >= q2) || (d == k45 && m >= p2 && m >= n0) ||
                        (d == k90 && m >= p1 && m >= n1) || (d == k135 && m >= p0 && m >= n2);
      const size_t at = static_cast<size_t>(r0 + r) * W;
      if (kMode == 0) {
        oc[at] = (keep && m >= low2) ? 1.f : 0.f;
      } else {
        oc[at] = __fmul_rn(m, keep ? 1.f : 0.f);
      }
      p0 = q0; p1 = q1; p2 = q2;
      q0 = n0; q1 = n1; q2 = n2;
    }
  }
}

// ------------------------------------------------------------- hysteresis

namespace cg = cooperative_groups;

constexpr int kHT = 32;          // hysteresis tile: kHT x kHT pixels
constexpr int kHThreads = 256;   // thread t walks column t % 32, rows 4 (t / 32) .. + 3
constexpr int kHRows = kHT * kHT / kHThreads;
constexpr unsigned char kOff = 0, kWeak = 1, kOn = 2;

__device__ __forceinline__ void store_edge(float* p, bool on) { *p = on ? 1.f : 0.f; }
__device__ __forceinline__ void store_edge(__nv_bfloat16* p, bool on) {
  *p = __float2bfloat16(on ? 1.f : 0.f);
}
__device__ __forceinline__ void store_edge(__half* p, bool on) { *p = __float2half(on ? 1.f : 0.f); }

// One tile of one round: load it with its halo, turn weak pixels with an
// on neighbour on until nothing changes, write it back if anything did.
// Returns (to every thread) whether the tile changed.
__device__ __forceinline__ bool relax_tile(unsigned char (*t)[kHT + 2], unsigned char* state,
                                           int tile, int tiles_h, int tiles_w, int H, int W) {
  const int n = tile / (tiles_h * tiles_w);
  const int r0 = (tile / tiles_w) % tiles_h * kHT;
  const int c0 = tile % tiles_w * kHT;
  unsigned char* sn = state + static_cast<size_t>(n) * H * W;
  for (int k = threadIdx.x; k < (kHT + 2) * (kHT + 2); k += kHThreads) {
    const int r = k / (kHT + 2), c = k % (kHT + 2);
    const int gr = r0 + r - 1, gc = c0 + c - 1;
    t[r][c] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                  ? __ldcg(sn + static_cast<size_t>(gr) * W + gc)
                  : kOff;
  }
  __syncthreads();
  const int c = 1 + threadIdx.x % kHT;
  const int rb = 1 + threadIdx.x / kHT * kHRows;
  bool changed = false;
  for (;;) {
    bool step = false;
#pragma unroll
    for (int i = 0; i < kHRows; ++i) {  // down the thread's rows: growth downwards is immediate
      const int r = rb + i;
      if (t[r][c] == kWeak &&
          (t[r - 1][c - 1] == kOn || t[r - 1][c] == kOn || t[r - 1][c + 1] == kOn ||
           t[r][c - 1] == kOn || t[r][c + 1] == kOn || t[r + 1][c - 1] == kOn ||
           t[r + 1][c] == kOn || t[r + 1][c + 1] == kOn)) {
        t[r][c] = kOn;
        step = true;
      }
    }
    if (!__syncthreads_or(step)) break;
    changed = true;
  }
  if (changed) {
    for (int k = threadIdx.x; k < kHT * kHT; k += kHThreads) {
      const int r = k / kHT, cc = k % kHT;
      const int gr = r0 + r, gc = c0 + cc;
      if (gr < H && gc < W && t[r + 1][cc + 1] == kOn)
        sn[static_cast<size_t>(gr) * W + gc] = kOn;
    }
  }
  __syncthreads();  // the tile's shared memory is free for the next one
  return changed;
}

// Cooperative; nms, out (N, H, W); state (N, H, W) uint8 scratch; flags: 4
// ints, [0, 3) the rounds' changed flags (round r uses r % 3), [3] the
// round count written at the end.
template <typename T>
__global__ void __launch_bounds__(kHThreads)
hysteresis_kernel(const float* __restrict__ nms, unsigned char* state, T* __restrict__ out,
                  int* flags, int N, int H, int W, float low, float high) {
  __shared__ unsigned char t[kHT + 2][kHT + 2];
  cg::grid_group grid = cg::this_grid();
  const size_t total = static_cast<size_t>(N) * H * W;
  const size_t stride = static_cast<size_t>(gridDim.x) * kHThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kHThreads + threadIdx.x; i < total;
       i += stride) {
    const float m = nms[i];
    state[i] = m >= high ? kOn : (m >= low ? kWeak : kOff);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[0] = 0;
  __threadfence();
  grid.sync();

  const int tiles_h = (H + kHT - 1) / kHT, tiles_w = (W + kHT - 1) / kHT;
  const int n_tiles = N * tiles_h * tiles_w;
  int round = 0;
  for (;;) {
    // flags[(round + 1) % 3] was last read after round round - 2 ended.
    if (blockIdx.x == 0 && threadIdx.x == 0) flags[(round + 1) % 3] = 0;
    bool changed = false;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
      changed |= relax_tile(t, state, tile, tiles_h, tiles_w, H, W);
    if (changed && threadIdx.x == 0) atomicExch(flags + round % 3, 1);
    __threadfence();
    grid.sync();
    const int any = __ldcg(flags + round % 3);
    ++round;
    if (!any) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[3] = round;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kHThreads + threadIdx.x; i < total;
       i += stride)
    store_edge(out + i, __ldcg(state + i) == kOn);
}

template <typename T>
cudaError_t hysteresis_launch(const float* nms, unsigned char* state, void* out, int* flags,
                              int N, int H, int W, float low, float high, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hysteresis_kernel<T>, kHThreads, 0);
  if (e != cudaSuccess) return e;
  const long long n_tiles = static_cast<long long>(N) * ((H + kHT - 1) / kHT) *
                            ((W + kHT - 1) / kHT);
  const int blocks = static_cast<int>(n_tiles < 1LL * sms * per_sm ? n_tiles : 1LL * sms * per_sm);
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  T* o = static_cast<T*>(out);
  void* args[] = {&nms, &state, &o, &flags, &N, &H, &W, &low, &high};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(hysteresis_kernel<T>),
                                  dim3(blocks), dim3(kHThreads), args, 0, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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

// out_dtype: 0 = float32, 1 = bfloat16, 2 = float16. nms: (N, H, W) float32
// (fused_canny's mode improve); state: N H W bytes of scratch; flags: 4
// ints of scratch, flags[3] receives the round count. All contiguous.
extern "C" int eelunet_hysteresis(int out_dtype, const void* nms, void* state, void* out,
                                  void* flags, int N, int H, int W, float low, float high,
                                  void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(nms);
  unsigned char* st = static_cast<unsigned char*>(state);
  int* f = static_cast<int*>(flags);
  if (out_dtype == 0) return hysteresis_launch<float>(m, st, out, f, N, H, W, low, high, s);
  if (out_dtype == 1)
    return hysteresis_launch<__nv_bfloat16>(m, st, out, f, N, H, W, low, high, s);
  if (out_dtype == 2) return hysteresis_launch<__half>(m, st, out, f, N, H, W, low, high, s);
  return cudaErrorInvalidValue;
}
