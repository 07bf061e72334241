// SAME 3x3 convolution as an implicit GEMM on Hopper's tensor cores (sm_90a),
// CUDA C++.
//
// Replaces the Pallas TPU kernel _conv_kernel of
// eelunet_tpu/ops/conv_pallas.py:42, launched by conv3x3_pallas (:73 -> :107):
// a SAME 3x3 stride-1 convolution of NHWC x (B, H, W, Cin) with HWIO weights
// (3, 3, Cin, Cout), products summed in float32, then the fused
// per-output-channel affine acc * scale + shift (float32) and an optional
// ReLU, written in x's type (float32 or bfloat16). Any B, H, W, Cin and
// Cout: the TPU kernel's tile_h and its W and Cin padding are tiling
// constraints of the TPU, not semantics.
//
// What bounds it on an H100: at the full-resolution decoder shape
// (8, 512, 512, 128) -> 64 in bf16 it does 2*B*H*W*9*Cin*Cout = 3.1e11
// flops, 0.313 ms at 989 TFLOP/s on the tensor cores, against 0.81 GB of
// bytes, 0.240 ms: operations bound it, so it has to run on the tensor cores
// and read x about once. The design:
//   - the GEMM: M = output pixels, N = Cout, K = 9 Cin, with no im2col in
//     device memory. A block owns kTH output rows x 32 output columns x 64
//     output channels and walks Cin in chunks of 16 channels; per chunk it
//     stages the input slab of (kTH + 2) x 34 pixels (zero outside the
//     image: the SAME padding) and the chunk's 3x3x16x64 weights in shared
//     memory. The A operand of tap (dy, dx) is the slab read at a row and
//     column offset: ldmatrix takes one address per lane, so the shifted
//     view costs nothing (the TPU kernel lost to XLA by building a shifted
//     slab per tap, conv_pallas.py:24-29);
//   - mma.sync.m16n8k16 (bf16 in, f32 sums, tc_bf16.cuh); warp w owns kWR
//     output rows (2 m16 tiles each) x all 64 output channels (8 n8 tiles),
//     so per tap it loads 4 B fragments by ldmatrix.trans (the weights stay
//     HWIO, output channels contiguous) and 2 kWR A fragments by ldmatrix;
//   - staged pixels are 48 bytes and weight rows 144 bytes apart, so the 8
//     rows one ldmatrix reads hit 8 distinct 16-byte bank groups;
//   - the epilogue applies scale, shift and ReLU in f32 (products and sums
//     rounded as the plain twin rounds them), stages the tile in x's type in
//     shared memory and writes it out in 16-byte stores;
//   - Cin or Cout that leave a 16-byte piece ragged, or a misaligned base,
//     are copied element by element (Cin = 3, Cout = 80).
// In bfloat16 (kP = 1) the chunks go through a 3-slot ring filled by 16-byte
// cp.async; a warp holds 2 rows (4 m16 tiles, 128 f32 accumulators), 16 rows
// a block. In float32 (kP = 3) x and w are split into three bf16 pieces as
// they are staged (tc_bf16.cuh split_pair) and every product is taken as
// bf16x6, the six piece products down to 2^-18 (CPU emulation, relative L2
// against JAX's f32 conv: 3.4e-7, against 4.4e-6 for bf16x3;
// tests/test_torch_port_conv_tc.py); each tap's six products go into a
// zeroed accumulator, smallest first, which joins the running sum by an f32
// add rounded to nearest (the tensor cores truncate as they add). A warp
// holds 1 row, 8 rows a block, one slot staged through registers. Its floor
// is 6 x 0.313 ms at the bf16 peak.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 3c,
// in turns with cuDNN): bf16 0.980 ms at 128 -> 64 and 0.551 ms at
// 64 -> 64 (cuDNN 1.181 and 0.893; the CUDA-core kernel it replaces took
// 13.163 and 6.617), 197 registers; float32 7.339 and 3.629 ms (cuDNN
// 8.861 and 5.096, TF32 off), 214 registers, relative L2 6.3e-7.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// stream it is given and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_once.cuh"
#include "tc_bf16.cuh"

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kTW = 32;              // output columns per block: 2 m16 tiles
constexpr int kCO = 64;              // output channels per block: 8 n8 tiles
constexpr int kKC = 16;              // input channels per chunk: one k16 step per tap
constexpr int kPitch = kKC + 8;      // bf16 per staged pixel: 48 bytes
constexpr int kWPitch = kCO + 8;     // bf16 per staged weight row: 144 bytes
constexpr int kSW = kTW + 2;         // slab columns

// The geometry of the kernel for kP bf16 pieces per operand (1: bf16 x and
// w; 3: f32 x and w split into three pieces, bf16x6 products).
template <int kP>
struct Geo {
  static constexpr int kWR = kP == 1 ? 2 : 1;        // output rows per warp
  static constexpr int kTH = 8 * kWR;                // output rows per block
  static constexpr int kMT = 2 * kWR;                // m16 tiles per warp
  static constexpr int kSH = kTH + 2;                // slab rows
  static constexpr int kSlab = kSH * kSW * kPitch;   // bf16 of one piece's slab
  static constexpr int kW = 9 * kKC * kWPitch;       // bf16 of one piece's weights
  static constexpr int kStage = kP * (kSlab + kW);   // bf16 per ring slot
  static constexpr int kStages = kP == 1 ? 3 : 1;
  static constexpr int kRingBytes = kStages * kStage * 2;
};

// The output tile staged in x's type, rows of kCO channels padded by 16 bytes.
template <typename T>
constexpr int kOPitch = kCO + 16 / static_cast<int>(sizeof(T));

template <typename T, int kP>
constexpr int kSmemBytes = Geo<kP>::kRingBytes > Geo<kP>::kTH * kTW * kOPitch<T> * static_cast<int>(sizeof(T))
                               ? Geo<kP>::kRingBytes
                               : Geo<kP>::kTH * kTW * kOPitch<T> * static_cast<int>(sizeof(T));

struct Shape {
  int H, W, Cin, Cout;
};

// Stage channels [c0, c0 + 16) of the slab at (h0 - 1, w0 - 1) and of the
// weights of output channels [co0, co0 + 64) into one slot, bf16, by
// 16-byte cp.async where a piece of 8 channels is whole and aligned, element
// by element where not; zeros outside the image and past Cin and Cout.
__device__ __forceinline__ void load_chunk(__nv_bfloat16* slot, const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ w, int b, int h0,
                                           int w0, int co0, int c0, Shape s, bool vec_x,
                                           bool vec_w) {
  constexpr int kSH = Geo<1>::kSH;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < kSH * kSW * 2; i += kThreads) {
    const int px = i >> 1;
    const int ch = c0 + (i & 1) * 8;
    const int sr = px / kSW;
    const int gr = h0 + sr - 1;
    const int gc = w0 + px - sr * kSW - 1;
    __nv_bfloat16* d = slot + px * kPitch + (i & 1) * 8;
    if (gr < 0 || gr >= s.H || gc < 0 || gc >= s.W || ch >= s.Cin) {
      cp_async16(d, x, 0);
      continue;
    }
    const __nv_bfloat16* src = x + ((static_cast<size_t>(b) * s.H + gr) * s.W + gc) * s.Cin + ch;
    if (vec_x && ch + 8 <= s.Cin) {
      cp_async16(d, src, 16);
    } else {
      for (int e = 0; e < 8; ++e) d[e] = ch + e < s.Cin ? src[e] : zero;
    }
  }
  __nv_bfloat16* ws = slot + Geo<1>::kSlab;
  for (int i = threadIdx.x; i < 9 * kKC * (kCO / 8); i += kThreads) {
    const int row = i / (kCO / 8);  // tap * kKC + channel of the chunk
    const int oc = co0 + (i % (kCO / 8)) * 8;
    const int tap = row / kKC;
    const int ch = c0 + row - tap * kKC;
    __nv_bfloat16* d = ws + row * kWPitch + (i % (kCO / 8)) * 8;
    if (ch >= s.Cin || oc >= s.Cout) {
      cp_async16(d, w, 0);
      continue;
    }
    const __nv_bfloat16* src = w + (static_cast<size_t>(tap) * s.Cin + ch) * s.Cout + oc;
    if (vec_w && oc + 8 <= s.Cout) {
      cp_async16(d, src, 16);
    } else {
      for (int e = 0; e < 8; ++e) d[e] = oc + e < s.Cout ? src[e] : zero;
    }
  }
}

// Four f32 values -> their three bf16 pieces, stored as 8 bytes in each of
// the three piece arrays (kStride bf16 apart) at d.
template <int kStride>
__device__ __forceinline__ void store_split4(__nv_bfloat16* d, float4 v) {
  unsigned lo[3], hi[3];
  split_pair<3>(v.x, v.y, lo);
  split_pair<3>(v.z, v.w, hi);
#pragma unroll
  for (int p = 0; p < 3; ++p) *reinterpret_cast<uint2*>(d + p * kStride) = make_uint2(lo[p], hi[p]);
}

// The float32 counterpart of load_chunk: loads through registers (float4
// where whole and aligned), splits each value into three bf16 pieces and
// stores piece p of the slab at slot + p kSlab and of the weights at
// slot + 3 kSlab + p kW.
__device__ __forceinline__ void load_chunk_split(__nv_bfloat16* slot, const float* __restrict__ x,
                                                 const float* __restrict__ w, int b, int h0,
                                                 int w0, int co0, int c0, Shape s, bool vec_x,
                                                 bool vec_w) {
  using G = Geo<3>;
  for (int i = threadIdx.x; i < G::kSH * kSW * (kKC / 4); i += kThreads) {
    const int px = i / (kKC / 4);
    const int q = i % (kKC / 4);
    const int ch = c0 + 4 * q;
    const int sr = px / kSW;
    const int gr = h0 + sr - 1;
    const int gc = w0 + px - sr * kSW - 1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr >= 0 && gr < s.H && gc >= 0 && gc < s.W && ch < s.Cin) {
      const float* src = x + ((static_cast<size_t>(b) * s.H + gr) * s.W + gc) * s.Cin + ch;
      if (vec_x && ch + 4 <= s.Cin) {
        v = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        v.x = __ldg(src);
        if (ch + 1 < s.Cin) v.y = __ldg(src + 1);
        if (ch + 2 < s.Cin) v.z = __ldg(src + 2);
        if (ch + 3 < s.Cin) v.w = __ldg(src + 3);
      }
    }
    store_split4<G::kSlab>(slot + px * kPitch + 4 * q, v);
  }
  __nv_bfloat16* ws = slot + 3 * G::kSlab;
  for (int i = threadIdx.x; i < 9 * kKC * (kCO / 4); i += kThreads) {
    const int row = i / (kCO / 4);
    const int oc = co0 + (i % (kCO / 4)) * 4;
    const int tap = row / kKC;
    const int ch = c0 + row - tap * kKC;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ch < s.Cin && oc < s.Cout) {
      const float* src = w + (static_cast<size_t>(tap) * s.Cin + ch) * s.Cout + oc;
      if (vec_w && oc + 4 <= s.Cout) {
        v = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        v.x = __ldg(src);
        if (oc + 1 < s.Cout) v.y = __ldg(src + 1);
        if (oc + 2 < s.Cout) v.z = __ldg(src + 2);
        if (oc + 3 < s.Cout) v.w = __ldg(src + 3);
      }
    }
    store_split4<G::kW>(ws + row * kWPitch + (i % (kCO / 4)) * 4, v);
  }
}

// The chunk's nine taps in bf16 on one staged slot, chained into acc.
template <int kMT>
__device__ __forceinline__ void mma_chunk(float (&acc)[kMT][8][4], const __nv_bfloat16* xs,
                                          const __nv_bfloat16* ws, int row0) {
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3;  // the ldmatrix matrix this lane addresses
  const int r8 = lane & 7;  // and its row there
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    // B (w, k16 x n8) fragments of the 8 n8 tiles, two per ldmatrix.trans:
    // matrices (k0-7, n), (k8-15, n), (k0-7, n+8), (k8-15, n+8).
    unsigned bf[8][2];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned r[4];
      ldmatrix_x4_trans(r, ws + (tap * kKC + (q & 1) * 8 + r8) * kWPitch + np * 16 + (q >> 1) * 8);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      // A (x, m16 x k16): 16 output pixels of one row, read at the tap's
      // offset; matrices (m0-7, k0-7), (m8-15, k0-7), (m0-7, k8-15), (m8-15, k8-15).
      const int px = (row0 + (mt >> 1) + dy) * kSW + (mt & 1) * 16 + dx + (q & 1) * 8 + r8;
      unsigned a[4];
      ldmatrix_x4(a, xs + px * kPitch + (q >> 1) * 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
    }
  }
}

// The same in bf16x6 on the three pieces of a float32 slot: per tap and
// tile the six piece products, smallest first, into a zeroed accumulator
// that joins acc by an f32 add rounded to nearest.
template <int kMT>
__device__ __forceinline__ void mma_chunk_split(float (&acc)[kMT][8][4], const __nv_bfloat16* xs,
                                                const __nv_bfloat16* ws, int row0) {
  using G = Geo<3>;
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3;
  const int r8 = lane & 7;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    unsigned a[kMT][3][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int px = (row0 + (mt >> 1) + dy) * kSW + (mt & 1) * 16 + dx + (q & 1) * 8 + r8;
#pragma unroll
      for (int p = 0; p < 3; ++p) ldmatrix_x4(a[mt][p], xs + p * G::kSlab + px * kPitch + (q >> 1) * 8);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned bf[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        ldmatrix_x4_trans(bf[p], ws + p * G::kW + (tap * kKC + (q & 1) * 8 + r8) * kWPitch +
                                     np * 16 + (q >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          // (piece of x, piece of w): (1,1), (2,0), (0,2), (1,0), (0,1), (0,0).
#pragma unroll
          for (int t = 5; t >= 0; --t) {
            const int pa = t == 2 || t == 5 ? 1 : t == 4 ? 2 : 0;
            const int pb = t == 1 || t == 5 ? 1 : t == 3 ? 2 : 0;
            mma_bf16(d, a[mt][pa], bf[pb][2 * h], bf[pb][2 * h + 1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][2 * np + h][e] += d[e];
        }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// grid (ceil(H / kTH) ceil(W / 32), B, ceil(Cout / 64)), kThreads threads,
// kSmemBytes<T, kP> of dynamic shared memory; x (B, H, W, Cin) and w
// (3, 3, Cin, Cout) of type T, scale and shift (Cout,) f32, out (B, H, W,
// Cout) of type T.
template <typename T, int kP>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel_tc(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  T* __restrict__ out, Shape s, int relu, bool vec_x, bool vec_w, bool vec_o) {
  using G = Geo<kP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles_w = (s.W + kTW - 1) / kTW;
  const int h0 = (blockIdx.x / tiles_w) * G::kTH;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const int b = blockIdx.y;
  const int co0 = blockIdx.z * kCO;
  const int row0 = warp * G::kWR;  // the warp's first output row in the tile
  const int n_chunks = (s.Cin + kKC - 1) / kKC;

  float acc[G::kMT][8][4];
#pragma unroll
  for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  if constexpr (kP == 1) {
    for (int st = 0; st < G::kStages - 1; ++st) {
      if (st < n_chunks)
        load_chunk(ring + st * G::kStage, x, w, b, h0, w0, co0, st * kKC, s, vec_x, vec_w);
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<G::kStages - 2>();  // chunk c has landed (this thread's pieces)
      __syncthreads();                  // everyone's pieces; slot c - 1 is free
      const int next = c + G::kStages - 1;
      if (next < n_chunks)
        load_chunk(ring + (next % G::kStages) * G::kStage, x, w, b, h0, w0, co0, next * kKC, s,
                   vec_x, vec_w);
      cp_async_commit();
      const __nv_bfloat16* xs = ring + (c % G::kStages) * G::kStage;
      mma_chunk<G::kMT>(acc, xs, xs + G::kSlab, row0);
    }
    cp_async_wait<0>();
  } else {
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();  // every warp is done with the previous chunk
      load_chunk_split(ring, x, w, b, h0, w0, co0, c * kKC, s, vec_x, vec_w);
      __syncthreads();
      mma_chunk_split<G::kMT>(acc, ring, ring + 3 * G::kSlab, row0);
    }
  }
  __syncthreads();  // the ring is free: it holds the output tile now

  // Epilogue: acc * scale + shift (each rounded, as the twin), ReLU, into the
  // staged tile in x's type; fragment (mt, nt) holds pixels g and g + 8 of
  // its m16 tile, channels nt 8 + 2 t4 and + 1.
  T* os = reinterpret_cast<T*>(smem_raw);
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int co = nt * 8 + 2 * t4;
    const int oc = co0 + co;
    const float sc0 = oc < s.Cout ? __ldg(scale + oc) : 0.f;
    const float sh0 = oc < s.Cout ? __ldg(shift + oc) : 0.f;
    const float sc1 = oc + 1 < s.Cout ? __ldg(scale + oc + 1) : 0.f;
    const float sh1 = oc + 1 < s.Cout ? __ldg(shift + oc + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < G::kMT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int px = (row0 + (mt >> 1)) * kTW + (mt & 1) * 16 + g + 8 * hh;
        float v0 = __fadd_rn(__fmul_rn(acc[mt][nt][2 * hh], sc0), sh0);
        float v1 = __fadd_rn(__fmul_rn(acc[mt][nt][2 * hh + 1], sc1), sh1);
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        store2(os + px * kOPitch<T> + co, v0, v1);
      }
  }
  __syncthreads();
  constexpr int kVals = 16 / static_cast<int>(sizeof(T));  // values per 16-byte piece
  constexpr int kPieces = kCO / kVals;                     // pieces per pixel
  for (int i = threadIdx.x; i < G::kTH * kTW * kPieces; i += kThreads) {
    const int px = i / kPieces;
    const int oc = co0 + (i % kPieces) * kVals;
    const int gr = h0 + px / kTW;
    const int gc = w0 + px % kTW;
    if (gr >= s.H || gc >= s.W || oc >= s.Cout) continue;
    const T* src = os + px * kOPitch<T> + (i % kPieces) * kVals;
    T* dst = out + ((static_cast<size_t>(b) * s.H + gr) * s.W + gc) * s.Cout + oc;
    if (vec_o && oc + kVals <= s.Cout) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kVals && oc + e < s.Cout; ++e) dst[e] = src[e];
    }
  }
}

template <typename T, int kP>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* shift,
                   void* out, int B, Shape s, int relu, cudaStream_t stream) {
  using G = Geo<kP>;
  constexpr int smem = kSmemBytes<T, kP>;
  static bool configured[kMaxDevices] = {};  // per device the instantiation runs on
  if (const cudaError_t e = set_smem_once(configured, conv3x3_kernel_tc<T, kP>, smem);
      e != cudaSuccess)
    return e;
  const long long tiles = static_cast<long long>((s.H + G::kTH - 1) / G::kTH) *
                          ((s.W + kTW - 1) / kTW);
  const int n_cb = (s.Cout + kCO - 1) / kCO;
  if (tiles > 2147483647LL || B > 65535 || n_cb > 65535) return cudaErrorInvalidValue;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_x = s.Cin % kVec == 0 && aligned(x);
  const bool vec_w = s.Cout % kVec == 0 && aligned(w);
  const bool vec_o = s.Cout % kVec == 0 && aligned(out);
  const dim3 grid(static_cast<unsigned>(tiles), B, n_cb);
  conv3x3_kernel_tc<T, kP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, shift, static_cast<T*>(out), s,
      relu, vec_x, vec_w, vec_o);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the type of x, w and out); scale and
// shift are (Cout,) float32. All tensors contiguous.
extern "C" int eelunet_conv3x3(int dtype, const void* x, const void* w, const void* scale,
                               const void* shift, void* out, int B, int H, int W, int Cin,
                               int Cout, int relu, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const Shape s = {H, W, Cin, Cout};
  if (dtype == 0) return launch<float, 3>(x, w, sc, sh, out, B, s, relu, st);
  if (dtype == 1) return launch<__nv_bfloat16, 1>(x, w, sc, sh, out, B, s, relu, st);
  return cudaErrorInvalidValue;
}

// Kernels of this library whose shared-memory attribute is set on device
// `dev` (one per instantiation launched there).
extern "C" int eelunet_conv3x3_configured(int dev) { return configured_on(dev); }
