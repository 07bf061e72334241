// Direct 3x3 convolution for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel _conv_kernel of
// eelunet_tpu/ops/conv_pallas.py:42, launched by conv3x3_pallas (:73 -> :107):
// a SAME 3x3 stride-1 convolution of NHWC x (B, H, W, Cin) with HWIO weights
// (3, 3, Cin, Cout), products accumulated in float32, then the fused
// per-output-channel affine acc * scale + shift (float32) and an optional
// ReLU, written in x's type (float32 or bfloat16). Any H, W, Cin and Cout:
// the TPU kernel's tile_h and its W and Cin padding are tiling constraints
// of the TPU, not semantics.
//
// What bounds it on an H100: at the full-resolution decoder shape
// (8, 512, 512, 128) -> 64 in bf16 it does 2*B*H*W*9*Cin*Cout = 3.1e11
// flops, 0.31 ms at 989 TFLOP/s on the tensor cores, against 0.81 GB of
// bytes, 0.24 ms: operations bound it. This first version stays on CUDA
// cores in float32 (tensor cores, mma.sync or wgmma, are later work), so it
// is far from that bound; the design keeps it simple (ptxas: 80 registers,
// 16 bytes of spill, 24.8 KB of shared memory per block):
//   - one block per (64-pixel segment of one output row, 64 output
//     channels); 256 threads, each owning 4 pixels (strided by 16) x 4
//     output channels, 16 float32 accumulators in registers;
//   - Cin is walked in chunks of 8: the chunk's 3 input rows x 66 columns
//     (zero outside the image: the SAME padding) and its 3x3x8x64 weights
//     are staged in shared memory as float32, 25 KB per block;
//   - per tap and input channel a thread reads 4 activations (broadcast
//     across the 16 threads of its pixel group) and one float4 of weights,
//     and does 16 FMAs.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// stream it is given and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 64;   // output pixels per block (one row segment)
constexpr int kCO = 64;   // output channels per block
constexpr int kCK = 8;    // input channels per shared-memory chunk
constexpr int kPix = 4;   // pixels per thread
constexpr int kCoT = 4;   // output channels per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// grid (ceil(W / kTW), H, B * ceil(Cout / kCO)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ shift,
               T* __restrict__ out, int H, int W, int Cin, int Cout, int relu) {
  __shared__ float xs[3][kTW + 2][kCK];
  __shared__ __align__(16) float ws[9][kCK][kCO];

  const int n_cb = (Cout + kCO - 1) / kCO;
  const int b = blockIdx.z / n_cb;
  const int co0 = (blockIdx.z - b * n_cb) * kCO;
  const int h = blockIdx.y;
  const int w0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int tx = tid % (kCO / kCoT);   // output-channel group: 4 channels
  const int ty = tid / (kCO / kCoT);   // pixel group: pixels ty + 16 k

  float acc[kPix][kCoT];
#pragma unroll
  for (int k = 0; k < kPix; ++k)
#pragma unroll
    for (int q = 0; q < kCoT; ++q) acc[k][q] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCK) {
    __syncthreads();  // every thread has read the previous chunk
    for (int i = tid; i < 3 * (kTW + 2) * kCK; i += kThreads) {
      const int ci = i % kCK;
      const int col = (i / kCK) % (kTW + 2);
      const int dy = i / (kCK * (kTW + 2));
      const int gr = h + dy - 1, gc = w0 + col - 1, ch = c0 + ci;
      float v = 0.f;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W && ch < Cin)
        v = to_f32(x[((static_cast<size_t>(b) * H + gr) * W + gc) * Cin + ch]);
      xs[dy][col][ci] = v;
    }
    for (int i = tid; i < 9 * kCK * kCO; i += kThreads) {
      const int co = i % kCO;
      const int ci = (i / kCO) % kCK;
      const int tap = i / (kCO * kCK);
      const int ch = c0 + ci, oc = co0 + co;
      float v = 0.f;
      if (ch < Cin && oc < Cout) v = to_f32(w[(static_cast<size_t>(tap) * Cin + ch) * Cout + oc]);
      ws[tap][ci][co] = v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int ci = 0; ci < kCK; ++ci) {
        const float4 wv = *reinterpret_cast<const float4*>(&ws[tap][ci][tx * kCoT]);
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const float xv = xs[dy][ty + 16 * k + dx][ci];
          acc[k][0] = fmaf(xv, wv.x, acc[k][0]);
          acc[k][1] = fmaf(xv, wv.y, acc[k][1]);
          acc[k][2] = fmaf(xv, wv.z, acc[k][2]);
          acc[k][3] = fmaf(xv, wv.w, acc[k][3]);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int gc = w0 + ty + 16 * k;
    if (gc >= W) continue;
    T* o = out + ((static_cast<size_t>(b) * H + h) * W + gc) * Cout;
#pragma unroll
    for (int q = 0; q < kCoT; ++q) {
      const int oc = co0 + tx * kCoT + q;
      if (oc >= Cout) continue;
      float v = fmaf(acc[k][q], scale[oc], shift[oc]);
      if (relu) v = fmaxf(v, 0.f);
      store(o + oc, v);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* shift,
                   void* out, int B, int H, int W, int Cin, int Cout, int relu,
                   cudaStream_t s) {
  const int n_cb = (Cout + kCO - 1) / kCO;
  if (static_cast<long long>(B) * n_cb > 65535 || H > 65535) return cudaErrorInvalidValue;
  const dim3 grid((W + kTW - 1) / kTW, H, B * n_cb);
  conv3x3_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                               static_cast<const T*>(w), scale, shift,
                                               static_cast<T*>(out), H, W, Cin, Cout, relu);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the type of x, w and out); scale and
// shift are (Cout,) float32. All tensors contiguous.
extern "C" int eelunet_conv3x3(int dtype, const void* x, const void* w, const void* scale,
                               const void* shift, void* out, int B, int H, int W, int Cin,
                               int Cout, int relu, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (dtype == 0) return launch<float>(x, w, sc, sh, out, B, H, W, Cin, Cout, relu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, sc, sh, out, B, H, W, Cin, Cout, relu, s);
  return cudaErrorInvalidValue;
}
