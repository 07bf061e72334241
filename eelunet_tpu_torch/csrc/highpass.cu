// FFT high-pass kernel pair for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels of eelunet_tpu/ops/fft_pallas.py:
//   contract_kernel_tc (bf16) and contract_kernel (f32)
//                    <- _contract_kernel / _contract_kernel_4d (:106 / :129)
//   expand_kernel_tc (bf16) and expand_kernel (f32)
//                    <- _expand_kernel   / _expand_kernel_4d   (:167 / :147)
// both launched there by _fwd_core (:205). The math is that of
// eelunet_tpu_torch/ops/fft.py: with x viewed as (B, H, W*C),
//   contract:  T[b] = V_H x[b]                      T: (B, K, W*C) complex, f32
//   expand:    out  = sqrt(max((x - Re U_H S)^2 + (Im U_H S)^2, 1e-24))
// where S is T after the W-axis middle (four skinny einsums, in PyTorch).
// K is 2m padded to a multiple of 16 with zero rows (exactly the unpadded
// operator); the wrapper passes K in {16, 32, 48, 64}. Any H and any W*C
// are taken: ragged tiles are masked inside the kernels, so there is no
// shape fallback.
//
// The contract in bf16 (the model's type), contract_kernel_tc. What bounds
// it on an H100: at (16,512,512,64) with K = 48 it reads x once (0.54 GB)
// and writes T (0.20 GB), 0.220 ms at 3.35 TB/s, against 2.6e10 FMAs: 0.052
// ms on the bf16 tensor cores, but 0.77 ms on CUDA cores in f32, so only the
// tensor cores let it be bound by bytes. The design:
//   - T = [V_r; V_i] x is one product per image with M = 2K rows; a block
//     owns all 2K rows and a strip of 128 columns and sums the whole of H
//     itself (no atomics, no second pass, deterministic);
//   - H goes by in chunks of 32 rows through a 4-slot ring of shared memory
//     filled by 16-byte cp.async: the x chunk and the matching rows of the
//     stacked factor [V_r^T | V_i^T], read through its two (H, K) halves;
//     staged rows are padded by 16 bytes so ldmatrix hits 8 bank groups;
//   - mma.sync.m16n8k16 (bf16 in, f32 sums), both operands by
//     ldmatrix.trans; warp w holds T_r (w < 4) or T_i rows and 32 columns;
//   - the epilogue writes each quad's 8 consecutive floats of a row as
//     float2s: whole 32-byte sectors;
//   - rows of x that are not 16-byte aligned (W*C not a multiple of 8, or a
//     misaligned base) and ragged pieces are copied element by element.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 3):
// 0.350 ms at (16,512,512,64), 63% of its bound, and 0.222 ms at
// (16,256,256,128), against 2.57 and 1.31 ms for the CUDA-core version it
// replaces and 0.249 and 0.167 ms for one torch.bmm writing f32.
// In float32 the contract stays on CUDA cores (contract_kernel): exact f32
// products, which TF32 would not give.
//
// The expand in bf16, expand_kernel_tc. Its factors U_H and spectrum S are
// f32 (the semantics of _fwd_core), and it does 4K FMAs per element of x:
// 1.0e11 at (16,512,512,64), 1.54 ms on CUDA cores in f32 against a 0.381
// ms bound from bytes (x and S read, out written). The tensor cores take f32
// at best in TF32, and one pass of TF32 misses the bf16 bound where the mask
// keeps the whole spectrum (|z| is then a small difference of large terms:
// 0.21 of max|out|, tests/test_torch_port_highpass_split.py). So it runs in
// bf16x3 (tc_bf16.cuh): U_H and S split into two bf16 pieces, three
// products, f32 sums, within 2^-16 of f32; its floor at the bf16 peak is
// 0.313 ms. The design, kernel 4's shape with the roles of the operands:
//   - out = |x - Ue [S_r; S_i]| per image, Ue the stacked, split U_H made
//     once with the factors; a block owns a strip of 128 columns and walks
//     H in chunks of 32 rows through a 3-slot cp.async ring (the chunk's
//     Ue rows and x tile);
//   - warp w owns 16 columns and holds their S, split in registers, as B
//     fragments for the whole of H (48 registers at K = 48);
//   - Ue's rows alternate 8 rows of A_re = [U_r | -U_i] and 8 of
//     A_im = [U_i | U_r], so one m16 tile of mma.sync.m16n8k16 gives each
//     lane lr and li of the same two pixels and the epilogue needs no
//     shuffle; out overwrites x in the slot and leaves in 16-byte stores.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 3):
// 1.119 ms at (16,512,512,64), 34% of its bound, and 0.612 ms at
// (16,256,256,128), against 3.36 and 1.71 ms for the CUDA-core version;
// 118 registers at K = 48, no spills. It is bound by neither bytes nor
// products alone: leaving out the Ue reloads, the x loads or the stores
// each saved a small part of its time, and a wgmma version (S^T in
// registers, Ue read once per warpgroup from shared memory) took as long.
// In float32 the expand (and the f32 contract) keep the first version's
// design on CUDA cores: one thread owns one column j of the (H, W*C) image
// and walks all of H; the K-row factor matrix is staged in shared memory a
// chunk of rows at a time and read as float4 broadcasts, four FMAs per
// load; the expand keeps its column of S (2K values) in registers.
//
// Interface: plain C functions, loaded with ctypes. Each launches on the
// stream it is given and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_once.cuh"
#include "tc_bf16.cuh"

namespace {

constexpr int kThreads = 128;  // columns per block
constexpr int kRows = 32;      // factor rows staged in shared memory per step
constexpr float kEps = 1e-24f;

// Stage rows [h0, h0 + rows) of two (H, K) row-major matrices into shared
// memory: row r holds a[h0 + r, 0:K] then b[h0 + r, 0:K].
template <int K>
__device__ __forceinline__ void stage_rows(float* s, const float* __restrict__ a,
                                           const float* __restrict__ b, int h0, int rows) {
  for (int i = threadIdx.x; i < rows * K; i += kThreads) {
    const int r = i / K;
    const int k = i - r * K;
    const size_t src = static_cast<size_t>(h0 + r) * K + k;
    s[r * 2 * K + k] = a[src];
    s[r * 2 * K + K + k] = b[src];
  }
}

// grid (ceil(WC / kThreads), B); x (B, H, WC), vr_t, vi_t (H, K) and
// tr, ti (B, K, WC), all f32.
template <int K>
__global__ void __launch_bounds__(kThreads)
contract_kernel(const float* __restrict__ x, const float* __restrict__ vr_t,
                const float* __restrict__ vi_t, float* __restrict__ tr,
                float* __restrict__ ti, int H, int WC) {
  __shared__ float4 sv[kRows][K / 2];  // per row: K real, then K imaginary
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const float* xb = x + static_cast<size_t>(b) * H * WC;

  float ar[K], ai[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ar[k] = 0.f;
    ai[k] = 0.f;
  }
  for (int h0 = 0; h0 < H; h0 += kRows) {
    const int rows = min(kRows, H - h0);
    __syncthreads();  // the previous chunk has been read by every thread
    stage_rows<K>(reinterpret_cast<float*>(sv), vr_t, vi_t, h0, rows);
    __syncthreads();
    if (j < WC) {
      for (int r = 0; r < rows; ++r) {
        const float xv = xb[static_cast<size_t>(h0 + r) * WC + j];
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          const float4 vr = sv[r][q];
          const float4 vi = sv[r][K / 4 + q];
          ar[4 * q + 0] = fmaf(vr.x, xv, ar[4 * q + 0]);
          ar[4 * q + 1] = fmaf(vr.y, xv, ar[4 * q + 1]);
          ar[4 * q + 2] = fmaf(vr.z, xv, ar[4 * q + 2]);
          ar[4 * q + 3] = fmaf(vr.w, xv, ar[4 * q + 3]);
          ai[4 * q + 0] = fmaf(vi.x, xv, ai[4 * q + 0]);
          ai[4 * q + 1] = fmaf(vi.y, xv, ai[4 * q + 1]);
          ai[4 * q + 2] = fmaf(vi.z, xv, ai[4 * q + 2]);
          ai[4 * q + 3] = fmaf(vi.w, xv, ai[4 * q + 3]);
        }
      }
    }
  }
  if (j < WC) {
    float* trb = tr + static_cast<size_t>(b) * K * WC + j;
    float* tib = ti + static_cast<size_t>(b) * K * WC + j;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      trb[static_cast<size_t>(k) * WC] = ar[k];
      tib[static_cast<size_t>(k) * WC] = ai[k];
    }
  }
}

// grid (ceil(WC / kThreads), B); x, out (B, H, WC), ur, ui (H, K) and
// sr, si (B, K, WC), all f32.
template <int K>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const float* __restrict__ x, const float* __restrict__ ur,
              const float* __restrict__ ui, const float* __restrict__ sr,
              const float* __restrict__ si, float* __restrict__ out, int H, int WC) {
  __shared__ float4 su[kRows][K / 2];  // per row: U_r then U_i
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * H * WC;

  float cr[K], ci[K];  // this column of S
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t at = (static_cast<size_t>(b) * K + k) * WC + j;
    cr[k] = j < WC ? sr[at] : 0.f;
    ci[k] = j < WC ? si[at] : 0.f;
  }
  for (int h0 = 0; h0 < H; h0 += kRows) {
    const int rows = min(kRows, H - h0);
    __syncthreads();
    stage_rows<K>(reinterpret_cast<float*>(su), ur, ui, h0, rows);
    __syncthreads();
    if (j < WC) {
      for (int r = 0; r < rows; ++r) {
        // Re(U S) = U_r S_r - U_i S_i ; Im(U S) = U_r S_i + U_i S_r,
        // as four independent sums for instruction-level parallelism.
        float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          const float4 a = su[r][q];
          const float4 c = su[r][K / 4 + q];
          rr = fmaf(a.x, cr[4 * q + 0], rr);
          rr = fmaf(a.y, cr[4 * q + 1], rr);
          rr = fmaf(a.z, cr[4 * q + 2], rr);
          rr = fmaf(a.w, cr[4 * q + 3], rr);
          ii = fmaf(c.x, ci[4 * q + 0], ii);
          ii = fmaf(c.y, ci[4 * q + 1], ii);
          ii = fmaf(c.z, ci[4 * q + 2], ii);
          ii = fmaf(c.w, ci[4 * q + 3], ii);
          ri = fmaf(a.x, ci[4 * q + 0], ri);
          ri = fmaf(a.y, ci[4 * q + 1], ri);
          ri = fmaf(a.z, ci[4 * q + 2], ri);
          ri = fmaf(a.w, ci[4 * q + 3], ri);
          ir = fmaf(c.x, cr[4 * q + 0], ir);
          ir = fmaf(c.y, cr[4 * q + 1], ir);
          ir = fmaf(c.z, cr[4 * q + 2], ir);
          ir = fmaf(c.w, cr[4 * q + 3], ir);
        }
        const size_t at = base + static_cast<size_t>(h0 + r) * WC + j;
        const float zr = x[at] - (rr - ii);
        const float zi = ri + ir;
        out[at] = sqrtf(fmaxf(zr * zr + zi * zi, kEps));
      }
    }
  }
}

// ------------------------------------------------ kernel 1 on tensor cores (bf16)
//
// T = [V_r; V_i] x per image as one product: M = 2K rows of the stacked
// V_H, N = a strip of kTcCols columns of x, and the sum runs over H in
// chunks of kTcRows, through a kTcStages-deep cp.async ring. Warp w owns
// the real (w < 4) or the imaginary half (K rows) of T and 32 of the
// strip's columns: K/16 x 4 tiles of mma.m16n8k16 (bf16 in, f32 out).
constexpr int kTcThreads = 256;       // 8 warps
constexpr int kTcCols = 128;          // columns of x per block
constexpr int kTcRows = 32;           // rows of H per ring slot
constexpr int kTcStages = 4;
constexpr int kXPitch = kTcCols + 8;  // bf16 per staged x row: +16 bytes, so the
                                      // 8 rows one ldmatrix reads hit 8 bank groups
template <int K>
constexpr int kVPitch = 2 * K + 8;  // a staged [V_r^T | V_i^T] row, padded alike
template <int K>
constexpr int kSlot = kTcRows * (kXPitch + kVPitch<K>);  // bf16 per ring slot
template <int K>
constexpr int kTcSmemBytes = kTcStages * kSlot<K> * 2;

// Fill one ring slot: rows [h0, h0 + kTcRows) of the block's x strip
// [j0, j0 + kTcCols) and of the stacked (H, 2K) factor [V_r^T | V_i^T],
// read through its two (H, K) halves. Rows past H and columns past WC are
// zeros. A 16-byte piece goes by cp.async when x's rows are 16-byte aligned
// (vec) and the piece lies inside the row; a ragged or misaligned piece is
// copied element by element.
template <int K>
__device__ __forceinline__ void load_slot(__nv_bfloat16* xs, __nv_bfloat16* vs,
                                          const __nv_bfloat16* __restrict__ xb,
                                          const __nv_bfloat16* __restrict__ vr_t,
                                          const __nv_bfloat16* __restrict__ vi_t, int h0,
                                          int j0, int H, int WC, bool vec) {
  constexpr int kXPieces = kTcRows * kTcCols / 8;
  for (int i = threadIdx.x; i < kXPieces; i += kTcThreads) {
    const int r = i / (kTcCols / 8);
    const int c = (i % (kTcCols / 8)) * 8;
    const int h = h0 + r;
    const int j = j0 + c;
    __nv_bfloat16* dst = xs + r * kXPitch + c;
    const __nv_bfloat16* src = xb + static_cast<size_t>(h) * WC + j;
    if (h >= H || j >= WC) {
      cp_async16(dst, xb, 0);
    } else if (vec && j + 8 <= WC) {
      cp_async16(dst, src, 16);
    } else {
      for (int e = 0; e < 8; ++e) dst[e] = j + e < WC ? src[e] : __float2bfloat16(0.f);
    }
  }
  constexpr int kVPieces = kTcRows * 2 * K / 8;
  for (int i = threadIdx.x; i < kVPieces; i += kTcThreads) {
    const int r = i / (2 * K / 8);
    const int c = (i % (2 * K / 8)) * 8;
    const int h = h0 + r;
    const __nv_bfloat16* src = c < K ? vr_t + static_cast<size_t>(h) * K + c
                                     : vi_t + static_cast<size_t>(h) * K + (c - K);
    cp_async16(vs + r * kVPitch<K> + c, h < H ? src : vr_t, h < H ? 16 : 0);
  }
}

// grid (ceil(WC / kTcCols), B), kTcThreads threads, kTcSmemBytes<K> of
// dynamic shared memory; x (B, H, WC) bf16; vr_t, vi_t (H, K) bf16;
// tr, ti (B, K, WC) f32.
template <int K>
__global__ void __launch_bounds__(kTcThreads, 2)
contract_kernel_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ vr_t,
                   const __nv_bfloat16* __restrict__ vi_t, float* __restrict__ tr,
                   float* __restrict__ ti, int H, int WC, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kMT = K / 16;  // m16 tiles of a warp's K rows
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = warp >> 2;          // 0: the rows of T_r, 1: those of T_i
  const int wcol = (warp & 3) * 32;    // the warp's 32 columns of the strip
  const int j0 = blockIdx.x * kTcCols;
  const int b = blockIdx.y;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * WC;
  const int n_chunks = (H + kTcRows - 1) / kTcRows;

  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_chunks)
      load_slot<K>(ring + s * kSlot<K>, ring + s * kSlot<K> + kTcRows * kXPitch, xb,
                   vr_t, vi_t, s * kTcRows, j0, H, WC, vec);
    cp_async_commit();
  }
  const int q = lane >> 3;  // the ldmatrix matrix this lane addresses
  const int r8 = lane & 7;  // and its row there
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kTcStages - 2>();  // chunk c has landed (this thread's pieces)
    __syncthreads();                 // everyone's pieces; slot c - 1 is free
    const int next = c + kTcStages - 1;
    if (next < n_chunks) {
      __nv_bfloat16* slot = ring + (next % kTcStages) * kSlot<K>;
      load_slot<K>(slot, slot + kTcRows * kXPitch, xb, vr_t, vi_t, next * kTcRows, j0, H, WC,
                   vec);
    }
    cp_async_commit();
    const __nv_bfloat16* xs = ring + (c % kTcStages) * kSlot<K>;
    const __nv_bfloat16* vs = xs + kTcRows * kXPitch;
#pragma unroll
    for (int k0 = 0; k0 < kTcRows; k0 += 16) {
      // B (x, k16 x n8) fragments of the warp's four n8 tiles, two per
      // ldmatrix: matrices (k0-7, n), (k8-15, n), (k0-7, n+8), (k8-15, n+8).
      unsigned bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(
            r, xs + (k0 + r8 + (q & 1) * 8) * kXPitch + wcol + np * 16 + (q >> 1) * 8);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        // A (V, m16 x k16) fragment from the staged V^T: matrices
        // (k0-7, m), (k0-7, m+8), (k8-15, m), (k8-15, m+8).
        unsigned af[4];
        ldmatrix_x4_trans(af, vs + (k0 + r8 + (q >> 1) * 8) * kVPitch<K> + half * K +
                                  mt * 16 + (q & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
  }
  // Each quad of lanes holds 8 consecutive columns of a row: float2 stores
  // fill whole 32-byte sectors.
  float* out = (half ? ti : tr) + static_cast<size_t>(b) * K * WC;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bool even = (WC & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = j0 + wcol + nt * 8 + t4 * 2;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* p = out + static_cast<size_t>(mt * 16 + g + hh * 8) * WC + j;
        const float v0 = acc[mt][nt][2 * hh];
        const float v1 = acc[mt][nt][2 * hh + 1];
        if (even && j + 1 < WC) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          if (j < WC) p[0] = v0;
          if (j + 1 < WC) p[1] = v1;
        }
      }
    }
}

template <int K>
cudaError_t contract_tc(const void* x, const void* vr_t, const void* vi_t, void* tr, void* ti,
                        int B, int H, int WC, cudaStream_t s) {
  constexpr int smem = kTcSmemBytes<K>;
  static bool configured[kMaxDevices] = {};  // per device the instantiation runs on
  if (const cudaError_t e = set_smem_once(configured, contract_kernel_tc<K>, smem);
      e != cudaSuccess)
    return e;
  const bool vec = WC % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((WC + kTcCols - 1) / kTcCols, B);
  contract_kernel_tc<K><<<grid, kTcThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(vr_t),
      static_cast<const __nv_bfloat16*>(vi_t), static_cast<float*>(tr),
      static_cast<float*>(ti), H, WC, vec);
  return cudaGetLastError();
}

// ------------------------------------------------ kernel 2 on tensor cores (bf16)
//
// out = |x - U_H S| per image as the product Ue [S_r; S_i] (2K deep) in
// bf16x3 (tc_bf16.cuh): a block owns a strip of kXpCols columns and walks H
// in chunks of kXpRows rows through a kXpStages<K>-deep cp.async ring (the
// chunk's 2 kXpRows Ue rows and its x tile); warp w owns 16 of the strip's
// columns and holds their S, split, as B fragments in registers for the
// whole of H. An m16 tile of the product gives lr and li of 8 rows of H, so
// the epilogue (zr = x - lr, sqrt(max(zr^2 + li^2, 1e-24))) needs no
// shuffle; it writes out over x in the slot, and the tile leaves in 16-byte
// stores.
constexpr int kXpThreads = 256;             // 8 warps
constexpr int kXpCols = 128;                // columns per block: 16 per warp
constexpr int kXpRows = 32;                 // rows of H per chunk: 4 m16 tiles
constexpr int kXpXPitch = kXpCols + 8;      // bf16 per staged x row: 68 words, = 4 mod 32
template <int K>
constexpr int kXpSlot = 2 * kXpRows * kUePitch<K, 2> + kXpRows * kXpXPitch;  // bf16
// Ring depth: 3 slots where 2 blocks of them fit an SM (K <= 48), else 2.
template <int K>
constexpr int kXpStages = K <= 48 ? 3 : 2;
template <int K>
constexpr int kXpSmemBytes = kXpStages<K> * kXpSlot<K> * 2;
constexpr int kXpM = 2;  // m16 tiles whose accumulators are live at once

template <int K>
__device__ __forceinline__ void expand_fill(__nv_bfloat16* slot, const __nv_bfloat16* __restrict__ ue,
                                            const __nv_bfloat16* __restrict__ xb, int c, int j0,
                                            int H, int WC, bool vec) {
  load_ue<K, 2, kXpRows / 8, kXpThreads>(slot, ue, c * kXpRows / 8, (H + 7) / 8);
  load_tile<kXpRows, kXpCols, kXpXPitch, kXpThreads>(slot + 2 * kXpRows * kUePitch<K, 2>, xb,
                                                      c * kXpRows, j0, H, WC, vec);
}

// grid (ceil(WC / kXpCols), B), kXpThreads threads, kXpSmemBytes<K> of
// dynamic shared memory; x, out (B, H, WC) bf16; ue (16 ceil(H/8), 6K)
// bf16, of which it reads pieces 0 and 1; sr, si (B, K, WC) f32. vec: x's
// and out's rows are 16-byte aligned.
template <int K>
__global__ void __launch_bounds__(kXpThreads, 2)
expand_kernel_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ue,
                 const float* __restrict__ sr, const float* __restrict__ si,
                 __nv_bfloat16* __restrict__ out, int H, int WC, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kStages = kXpStages<K>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wcol = (threadIdx.x >> 5) * 16;  // the warp's 16 columns of the strip
  const int j0 = blockIdx.x * kXpCols;
  const int b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * H * WC;
  const int n_chunks = (H + kXpRows - 1) / kXpRows;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) expand_fill<K>(ring + s * kXpSlot<K>, ue, x + base, s, j0, H, WC, vec);
    cp_async_commit();
  }
  unsigned sf[2][2 * K / 16][2][2];  // S, hi and lo
  load_s_frags<K, 2>(sf, sr, si, b, j0 + wcol, WC);

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's pieces)
    __syncthreads();               // everyone's; the slot of chunk c - 1 is free
    const int next = c + kStages - 1;
    if (next < n_chunks)
      expand_fill<K>(ring + (next % kStages) * kXpSlot<K>, ue, x + base, next, j0, H, WC, vec);
    cp_async_commit();
    const __nv_bfloat16* us = ring + (c % kStages) * kXpSlot<K>;
    __nv_bfloat16* xs = ring + (c % kStages) * kXpSlot<K> + 2 * kXpRows * kUePitch<K, 2>;
#pragma unroll
    for (int mp = 0; mp < kXpRows / 8; mp += kXpM) {
      float acc[kXpM][2][4];
#pragma unroll
      for (int m = 0; m < kXpM; ++m)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
      rebuild<K, 2, kXpM, false>(acc, us, mp, sf);
#pragma unroll
      for (int m = 0; m < kXpM; ++m)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          unsigned* p = reinterpret_cast<unsigned*>(xs + ((mp + m) * 8 + g) * kXpXPitch + wcol +
                                                    nt * 8 + t4 * 2);
          const unsigned w = *p;
          const float zr0 = __uint_as_float(w << 16) - acc[m][nt][0];
          const float zr1 = __uint_as_float(w & 0xffff0000u) - acc[m][nt][1];
          const float li0 = acc[m][nt][2];
          const float li1 = acc[m][nt][3];
          *p = bf16x2_bits(__floats2bfloat162_rn(sqrtf(fmaxf(zr0 * zr0 + li0 * li0, kEps)),
                                                 sqrtf(fmaxf(zr1 * zr1 + li1 * li1, kEps))));
        }
    }
    __syncthreads();
    store_tile<kXpRows, kXpCols, kXpXPitch, kXpThreads>(out + base, xs, c * kXpRows, j0, H, WC,
                                                        vec);
  }
}

template <int K>
cudaError_t expand_tc(const void* x, const void* ue, const void* sr, const void* si, void* out,
                      int B, int H, int WC, cudaStream_t s) {
  constexpr int smem = kXpSmemBytes<K>;
  static bool configured[kMaxDevices] = {};  // per device the instantiation runs on
  if (const cudaError_t e = set_smem_once(configured, expand_kernel_tc<K>, smem);
      e != cudaSuccess)
    return e;
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = WC % 8 == 0 && addr(x) % 16 == 0 && addr(out) % 16 == 0;
  const dim3 grid((WC + kXpCols - 1) / kXpCols, B);
  expand_kernel_tc<K><<<grid, kXpThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(ue),
      static_cast<const float*>(sr), static_cast<const float*>(si),
      static_cast<__nv_bfloat16*>(out), H, WC, vec);
  return cudaGetLastError();
}

cudaError_t launch_expand_bf16(int K, const void* x, const void* ue, const void* sr,
                               const void* si, void* out, int B, int H, int WC, cudaStream_t s) {
  switch (K) {
    case 16: return expand_tc<16>(x, ue, sr, si, out, B, H, WC, s);
    case 32: return expand_tc<32>(x, ue, sr, si, out, B, H, WC, s);
    case 48: return expand_tc<48>(x, ue, sr, si, out, B, H, WC, s);
    case 64: return expand_tc<64>(x, ue, sr, si, out, B, H, WC, s);
    default: return cudaErrorInvalidValue;
  }
}

// bf16: the tensor-core kernel; float32: the CUDA-core kernel, exact f32.
cudaError_t launch_contract_bf16(int K, const void* x, const void* vr_t, const void* vi_t,
                                 void* tr, void* ti, int B, int H, int WC, cudaStream_t s) {
  switch (K) {
    case 16: return contract_tc<16>(x, vr_t, vi_t, tr, ti, B, H, WC, s);
    case 32: return contract_tc<32>(x, vr_t, vi_t, tr, ti, B, H, WC, s);
    case 48: return contract_tc<48>(x, vr_t, vi_t, tr, ti, B, H, WC, s);
    case 64: return contract_tc<64>(x, vr_t, vi_t, tr, ti, B, H, WC, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_contract_f32(int K, const void* x, const void* vr_t, const void* vi_t,
                                void* tr, void* ti, int B, int H, int WC, cudaStream_t s) {
  const dim3 grid((WC + kThreads - 1) / kThreads, B);
  const float* xp = static_cast<const float*>(x);
  const float* vr = static_cast<const float*>(vr_t);
  const float* vi = static_cast<const float*>(vi_t);
  float* a = static_cast<float*>(tr);
  float* c = static_cast<float*>(ti);
  switch (K) {
    case 16: contract_kernel<16><<<grid, kThreads, 0, s>>>(xp, vr, vi, a, c, H, WC); break;
    case 32: contract_kernel<32><<<grid, kThreads, 0, s>>>(xp, vr, vi, a, c, H, WC); break;
    case 48: contract_kernel<48><<<grid, kThreads, 0, s>>>(xp, vr, vi, a, c, H, WC); break;
    case 64: contract_kernel<64><<<grid, kThreads, 0, s>>>(xp, vr, vi, a, c, H, WC); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_expand_f32(int K, const void* x, const void* ur, const void* ui,
                              const void* sr, const void* si, void* out, int B, int H, int WC,
                              cudaStream_t s) {
  const dim3 grid((WC + kThreads - 1) / kThreads, B);
  const float* xp = static_cast<const float*>(x);
  const float* a = static_cast<const float*>(ur);
  const float* c = static_cast<const float*>(ui);
  const float* p = static_cast<const float*>(sr);
  const float* q = static_cast<const float*>(si);
  float* o = static_cast<float*>(out);
  switch (K) {
    case 16: expand_kernel<16><<<grid, kThreads, 0, s>>>(xp, a, c, p, q, o, H, WC); break;
    case 32: expand_kernel<32><<<grid, kThreads, 0, s>>>(xp, a, c, p, q, o, H, WC); break;
    case 48: expand_kernel<48><<<grid, kThreads, 0, s>>>(xp, a, c, p, q, o, H, WC); break;
    case 64: expand_kernel<64><<<grid, kThreads, 0, s>>>(xp, a, c, p, q, o, H, WC); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the type of x, V_H^T and out).
extern "C" int eelunet_highpass_contract(int dtype, int K, const void* x, const void* vr_t,
                                         const void* vi_t, void* tr, void* ti, int B,
                                         int H, int WC, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_contract_f32(K, x, vr_t, vi_t, tr, ti, B, H, WC, s);
  if (dtype == 1) return launch_contract_bf16(K, x, vr_t, vi_t, tr, ti, B, H, WC, s);
  return cudaErrorInvalidValue;
}

// ue: the stacked, split U_H of tc_bf16.cuh, read by the bf16 kernel only.
extern "C" int eelunet_highpass_expand(int dtype, int K, const void* x, const void* ur,
                                       const void* ui, const void* ue, const void* sr,
                                       const void* si, void* out, int B, int H, int WC,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_expand_f32(K, x, ur, ui, sr, si, out, B, H, WC, s);
  if (dtype == 1) return launch_expand_bf16(K, x, ue, sr, si, out, B, H, WC, s);
  return cudaErrorInvalidValue;
}

// Kernels of this library whose shared-memory attribute is set on device
// `dev` (one per instantiation launched there).
extern "C" int eelunet_highpass_configured(int dev) { return configured_on(dev); }
