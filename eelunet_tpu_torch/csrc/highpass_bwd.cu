// FFT high-pass backward kernel pair for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels of eelunet_tpu/ops/fft_pallas.py:
//   bwd_contract_kernel_tc (bf16) and bwd_contract_kernel (f32)
//                       <- _bwd_contract_kernel (:390)
//   bwd_expand_kernel_tc (bf16) and bwd_expand_kernel (f32)
//                       <- _bwd_expand_kernel   (:427)
// both launched there by _bwd_core (:453). With x and the cotangent g viewed
// as (B, H, W*C) and S the saved skinny spectrum of the forward:
//   contract:  z = x - U_H S (complex, rebuilt per column from S);
//              u = g z/|z|, 0 where |z|^2 < 1e-24 (the forward's clamp);
//              writes Re u in the model type and T = U_H^T conj(u),
//              (B, K, W*C) f32, accumulated from the unrounded f32 u.
//   expand:    dx = f32(Re u) - Re(V_H^T R), rounded to the model type, where
//              R is T after the W-axis middle (four skinny einsums, in PyTorch).
// x, g, u and dx share one type, f32 or bf16: autograd hands the backward a
// cotangent in its output's type, which is x's. U_H, V_H^T, S and R are f32
// (the semantics of _bwd_core, not of _highpass_bwd_impl, which casts U_H to
// the model type). Any H and any W*C are taken (ragged tiles are masked), so
// there is no shape fallback.
//
// The contract in a bf16 model, bwd_contract_kernel_tc. What bounds it on
// an H100: at (8,512,512,64) with K = 48 it reads x, g and S and writes
// Re u and T (1.01 GB, 0.301 ms at 3.35 TB/s), with 8K FMAs per element
// (rebuild and T), 1.54 ms on CUDA cores in f32. On the tensor cores its f32
// products are split into bf16 pieces (tc_bf16.cuh), and the arithmetic is
// set by T's bound, 1e-4 of max|T|: near pixels where |z| is small,
// u = g z/|z| turns with z's error, and T sums those turns. A bf16x3 rebuild
// of z (2^-16) moves T by 2e-4 of max|T| at (2,256,256,8) (CPU emulation,
// tests/test_torch_port_highpass_split.py), over the bound; so z is rebuilt
// in bf16x6 (three pieces, six products) and T, whose own error does not
// turn, is summed in bf16x3. The tensor cores also truncate where they add
// into their f32 accumulator, about one unit in the last place per mma, and
// a pixel's rebuild chains 36 of them: each k16 step's products are summed
// from zero and added into the totals with an f32 add rounded to nearest
// (T moved from 8.4e-5 to 1.8e-5 of max|T| at (8,256,256,128)). The
// arithmetic's floor at the bf16 peak is 0.469 ms at the 512 site, above
// the bytes. Design: below (kernel 3 on tensor cores).
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase
// 3b): 1.886 ms at (8,512,512,64), 16% of its bound and 25% of its floor,
// and 0.972 ms at (8,256,256,128), against 5.24 and 2.66 ms for the
// CUDA-core version; T within 5.7e-6 and 1.8e-5 of max|T|. ptxas: 245
// registers at K = 48, no spills; 255 and a 16-byte spill at K = 64.
// In float32 the contract stays on CUDA cores (bwd_contract_kernel): one
// thread owns one column and walks the whole of H, T's 2K accumulators in
// registers, the block's S columns in dynamic shared memory as float4s laid
// out [k/4][thread], the U_H rows staged 32 at a time and read as float4
// broadcasts; 168 registers at K = 48 (3 blocks per SM), 254 at K = 64.
//
// The expand in a bf16 model, bwd_expand_kernel_tc. What bounds it on an
// H100: at (8,512,512,64) with K = 48 it reads R and u and writes dx (0.64
// GB, 0.190 ms at 3.35 TB/s) with 2K FMAs per element: 0.052 ms in TF32 on
// the tensor cores, 0.39 ms on CUDA cores in f32. The design:
//   - dx = u - A R with A = [V_r^T | -V_i^T] (H x 2K) and R = [R_r; R_i],
//     each read through its two pointers; a block owns a strip of 128
//     columns and walks H in chunks of 64 rows;
//   - warp w owns 16 of the strip's columns and holds their R (2K x 16,
//     rounded to TF32) as mma B fragments in registers for the whole of H;
//   - each chunk's A rows and u tile come by 16-byte cp.async into a 2-slot
//     ring, one chunk ahead of the products; each thread rounds the A
//     pieces it copied to TF32 in place (the imaginary half negated);
//   - mma.sync.m16n8k8 in TF32 with f32 sums, A fragments from shared
//     memory (rows padded to 4 mod 32 words: conflict-free). wgmma in TF32
//     takes only K-major operands and R is N-major, so mma.sync it is;
//   - dx = u - acc overwrites u in the slot, and the tile leaves in 16-byte
//     stores: the lanes' own 4-byte stores, 16 bytes of a row each, were
//     slower on the card.
// TF32 keeps 10 mantissa bits; both operands are rounded to nearest even
// (to_tf32), so dx is off by a few 1e-4 of |Re u|: relative L2 2.5e-4 at
// the 512 site, inside the 1e-2 the card holds bf16 dx to. Where the mask
// keeps the whole spectrum (2m >= H and W) the exact z is 0 and dx is set
// by the f32 summation order of z's rebuild: reversing it moves dx by 1.35
// in relative L2 at (2,32,32,16) (tests/test_torch_port_highpass_tc.py). No
// kernel reproduces the reference's dx there; it is held relative to |Re u|.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase
// 3b): 0.340 ms at (8,512,512,64), 56% of its bound, and 0.192 ms at
// (8,256,256,128), against 1.48 and 0.76 ms for the CUDA-core version it
// replaces and 0.468 and 0.242 ms for a bf16 torch.baddbmm (0.982 and
// 0.492 ms for an f32 one in TF32).
// In float32 the expand stays on CUDA cores (bwd_expand_kernel): 1e-5 of
// relative L2 is below what TF32 gives.
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

// Stage rows [h0, h0 + rows) of two (H, K) row-major f32 matrices into shared
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

template <int K>
constexpr int contract_smem_bytes() {
  return (kRows * 2 * K + 2 * K * kThreads) * static_cast<int>(sizeof(float));
}

// Blocks per SM the contract is compiled for: 3 caps it at 168 registers
// (65536 / (3 * 128)), which the 2K = 96 accumulators of K = 48 fit with
// the loop's temporaries; the shared memory (60 KB at K = 48) also allows 3.
// K = 64 (mask_range 25-32) needs 2K = 128 accumulators: compiled for 2
// blocks per SM it takes 254 registers and spills nothing.
template <int K>
constexpr int kContractBlocks = K <= 48 ? 3 : 2;

// grid (ceil(WC / kThreads), B); x, g, u_re (B, H, WC), ur, ui (H, K),
// sr, si and tr, ti (B, K, WC), all f32.
template <int K>
__global__ void __launch_bounds__(kThreads, kContractBlocks<K>)
bwd_contract_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ ur, const float* __restrict__ ui,
                    const float* __restrict__ sr, const float* __restrict__ si,
                    float* __restrict__ u_re, float* __restrict__ tr, float* __restrict__ ti,
                    int H, int WC) {
  extern __shared__ float4 smem[];
  float4 (*su)[K / 2] = reinterpret_cast<float4 (*)[K / 2]>(smem);  // U rows: U_r then U_i
  // This block's S columns: ss[q * kThreads + t] holds S_r[4q..4q+3] of
  // thread t's column, ss[(K/4 + q) * kThreads + t] S_i[4q..4q+3].
  float4* ss = smem + kRows * (K / 2);
  const int tid = threadIdx.x;
  const int j = blockIdx.x * kThreads + tid;
  const int b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * H * WC;

  for (int q = 0; q < K / 4; ++q) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t at = (static_cast<size_t>(b) * K + 4 * q + e) * WC + j;
      v[e] = j < WC ? sr[at] : 0.f;
      v[4 + e] = j < WC ? si[at] : 0.f;
    }
    ss[q * kThreads + tid] = make_float4(v[0], v[1], v[2], v[3]);
    ss[(K / 4 + q) * kThreads + tid] = make_float4(v[4], v[5], v[6], v[7]);
  }
  float ar[K], ai[K];  // T_r, T_i of this column
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ar[k] = 0.f;
    ai[k] = 0.f;
  }
  for (int h0 = 0; h0 < H; h0 += kRows) {
    const int rows = min(kRows, H - h0);
    __syncthreads();  // the previous chunk has been read by every thread
    stage_rows<K>(reinterpret_cast<float*>(su), ur, ui, h0, rows);
    __syncthreads();
    if (j < WC) {
      for (int r = 0; r < rows; ++r) {
        // Re(U S) = U_r S_r - U_i S_i ; Im(U S) = U_r S_i + U_i S_r,
        // as four independent sums for instruction-level parallelism.
        // Unrolled by 2 only: T's 2K accumulators are live throughout, and
        // a full unroll hoists every load of S and U ahead (255 registers
        // and spills at K = 48).
        float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
#pragma unroll 2
        for (int q = 0; q < K / 4; ++q) {
          const float4 a = su[r][q];
          const float4 c = su[r][K / 4 + q];
          const float4 sv = ss[q * kThreads + tid];
          const float4 tv = ss[(K / 4 + q) * kThreads + tid];
          rr = fmaf(a.x, sv.x, rr);
          rr = fmaf(a.y, sv.y, rr);
          rr = fmaf(a.z, sv.z, rr);
          rr = fmaf(a.w, sv.w, rr);
          ii = fmaf(c.x, tv.x, ii);
          ii = fmaf(c.y, tv.y, ii);
          ii = fmaf(c.z, tv.z, ii);
          ii = fmaf(c.w, tv.w, ii);
          ri = fmaf(a.x, tv.x, ri);
          ri = fmaf(a.y, tv.y, ri);
          ri = fmaf(a.z, tv.z, ri);
          ri = fmaf(a.w, tv.w, ri);
          ir = fmaf(c.x, sv.x, ir);
          ir = fmaf(c.y, sv.y, ir);
          ir = fmaf(c.z, sv.z, ir);
          ir = fmaf(c.w, sv.w, ir);
        }
        const size_t at = base + static_cast<size_t>(h0 + r) * WC + j;
        const float zr = x[at] - (rr - ii);
        const float zi = -(ri + ir);
        const float sq = zr * zr + zi * zi;
        const float coef = sq >= kEps ? g[at] / sqrtf(fmaxf(sq, kEps)) : 0.f;
        const float vr = coef * zr;
        const float vi = coef * zi;
        u_re[at] = vr;
        // T_r += U_r ur + U_i ui ; T_i += U_i ur - U_r ui  (U_H^T conj(u))
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          const float4 a = su[r][q];
          const float4 c = su[r][K / 4 + q];
          ar[4 * q + 0] = fmaf(a.x, vr, fmaf(c.x, vi, ar[4 * q + 0]));
          ar[4 * q + 1] = fmaf(a.y, vr, fmaf(c.y, vi, ar[4 * q + 1]));
          ar[4 * q + 2] = fmaf(a.z, vr, fmaf(c.z, vi, ar[4 * q + 2]));
          ar[4 * q + 3] = fmaf(a.w, vr, fmaf(c.w, vi, ar[4 * q + 3]));
          ai[4 * q + 0] = fmaf(c.x, vr, fmaf(-a.x, vi, ai[4 * q + 0]));
          ai[4 * q + 1] = fmaf(c.y, vr, fmaf(-a.y, vi, ai[4 * q + 1]));
          ai[4 * q + 2] = fmaf(c.z, vr, fmaf(-a.z, vi, ai[4 * q + 2]));
          ai[4 * q + 3] = fmaf(c.w, vr, fmaf(-a.w, vi, ai[4 * q + 3]));
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

// grid (ceil(WC / kThreads), B); vr_t, vi_t (H, K), rr, ri (B, K, WC) and
// u_re, dx (B, H, WC), all f32.
template <int K>
__global__ void __launch_bounds__(kThreads)
bwd_expand_kernel(const float* __restrict__ vr_t, const float* __restrict__ vi_t,
                  const float* __restrict__ rr, const float* __restrict__ ri,
                  const float* __restrict__ u_re, float* __restrict__ dx, int H, int WC) {
  __shared__ float4 sv[kRows][K / 2];  // per row: V_r^T then V_i^T
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * H * WC;

  float cr[K], ci[K];  // this column of R
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t at = (static_cast<size_t>(b) * K + k) * WC + j;
    cr[k] = j < WC ? rr[at] : 0.f;
    ci[k] = j < WC ? ri[at] : 0.f;
  }
  for (int h0 = 0; h0 < H; h0 += kRows) {
    const int rows = min(kRows, H - h0);
    __syncthreads();
    stage_rows<K>(reinterpret_cast<float*>(sv), vr_t, vi_t, h0, rows);
    __syncthreads();
    if (j < WC) {
      for (int r = 0; r < rows; ++r) {
        // Re(V_H^T R) = V_r^T R_r - V_i^T R_i, as two pairs of sums.
        float p0 = 0.f, p1 = 0.f, n0 = 0.f, n1 = 0.f;
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          const float4 a = sv[r][q];
          const float4 c = sv[r][K / 4 + q];
          p0 = fmaf(a.x, cr[4 * q + 0], p0);
          p1 = fmaf(a.y, cr[4 * q + 1], p1);
          p0 = fmaf(a.z, cr[4 * q + 2], p0);
          p1 = fmaf(a.w, cr[4 * q + 3], p1);
          n0 = fmaf(c.x, ci[4 * q + 0], n0);
          n1 = fmaf(c.y, ci[4 * q + 1], n1);
          n0 = fmaf(c.z, ci[4 * q + 2], n0);
          n1 = fmaf(c.w, ci[4 * q + 3], n1);
        }
        const size_t at = base + static_cast<size_t>(h0 + r) * WC + j;
        dx[at] = u_re[at] - ((p0 + p1) - (n0 + n1));
      }
    }
  }
}

template <int K>
cudaError_t contract_f32(const void* x, const void* g, const void* ur, const void* ui,
                         const void* sr, const void* si, void* u, void* tr, void* ti, int B,
                         int H, int WC, cudaStream_t s) {
  constexpr int smem = contract_smem_bytes<K>();
  static bool configured[kMaxDevices] = {};  // per device the instantiation runs on
  if (const cudaError_t e = set_smem_once(configured, bwd_contract_kernel<K>, smem);
      e != cudaSuccess)
    return e;
  const dim3 grid((WC + kThreads - 1) / kThreads, B);
  bwd_contract_kernel<K><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<const float*>(ur),
      static_cast<const float*>(ui), static_cast<const float*>(sr),
      static_cast<const float*>(si), static_cast<float*>(u), static_cast<float*>(tr),
      static_cast<float*>(ti), H, WC);
  return cudaGetLastError();
}

cudaError_t launch_contract_f32(int K, const void* x, const void* g, const void* ur,
                                const void* ui, const void* sr, const void* si, void* u,
                                void* tr, void* ti, int B, int H, int WC, cudaStream_t s) {
  switch (K) {
    case 16: return contract_f32<16>(x, g, ur, ui, sr, si, u, tr, ti, B, H, WC, s);
    case 32: return contract_f32<32>(x, g, ur, ui, sr, si, u, tr, ti, B, H, WC, s);
    case 48: return contract_f32<48>(x, g, ur, ui, sr, si, u, tr, ti, B, H, WC, s);
    case 64: return contract_f32<64>(x, g, ur, ui, sr, si, u, tr, ti, B, H, WC, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------ kernel 3 on tensor cores (bf16x6 and bf16x3)
//
// Per image, one block owns a strip of kBcCols columns and sums the whole
// of H itself (no atomics, no second pass: deterministic). Per chunk of
// kBcRows rows of H, staged by cp.async (Ue rows, x and g tiles) through a
// 2-slot ring, and per m16 tile (8 rows of H):
//   1. lr, li = Ue [S_r; S_i] on the tensor cores in bf16x6 (rebuild in
//      tc_bf16.cuh), S split into three pieces in registers for all of H;
//   2. z = (x - lr, -li), u = g z/|z| (0 below the floor) in the
//      accumulators; Re u overwrites x in the slot;
//   3. u_r, u_i split into bf16 hi and lo; a movmatrix transposes each
//      accumulator 8x8 (rows of H x columns) into the B fragment of the
//      next product, whose k16 step is the m16 tile's 8 rows of u_r, then
//      its 8 rows of u_i: no shared memory, no shuffle;
//   4. T' += Ue^T u, M = 2K, in bf16x3, A fragments from the same staged
//      Ue (pieces 0 and 1) by ldmatrix.trans. Ue's rows are [U_r | -U_i]
//      and [U_i | U_r], so T' = [T_r; -T_i]: T_i's sign flips on the way out.
// Warp w owns 16 columns; its S fragments (3K / 2 registers) and T'
// accumulators (K) live for the whole of H: 120 registers at K = 48 before
// the rebuild's, so it is compiled for 2 blocks of 4 warps per SM (up to
// 255 registers), and one m16 tile of the rebuild is live at a time (two
// spilled at K = 48 and were slower).
constexpr int kBcThreads = 128;       // 4 warps
constexpr int kBcCols = 64;           // columns per block: 16 per warp
constexpr int kBcXPitch = kBcCols + 8;  // bf16 per staged x or g row: 36 words, = 4 mod 32
// Rows of H per chunk: 4 m16 tiles; 2 at K = 64, so that two blocks' rings
// fit an SM (94 KB a block at K = 48, 59 KB at K = 64).
template <int K>
constexpr int kBcRows = K <= 48 ? 32 : 16;
template <int K>
constexpr int kBcSlot = 2 * kBcRows<K> * kUePitch<K, 3> + 2 * kBcRows<K> * kBcXPitch;  // bf16
template <int K>
constexpr int kBcSmemBytes = 2 * kBcSlot<K> * 2;

template <int K>
__device__ __forceinline__ void bwd_contract_fill(__nv_bfloat16* slot,
                                                  const __nv_bfloat16* __restrict__ ue,
                                                  const __nv_bfloat16* __restrict__ xb,
                                                  const __nv_bfloat16* __restrict__ gb, int c,
                                                  int j0, int H, int WC, bool vec) {
  constexpr int kRows = kBcRows<K>;
  load_ue<K, 3, kRows / 8, kBcThreads>(slot, ue, c * kRows / 8, (H + 7) / 8);
  __nv_bfloat16* xs = slot + 2 * kRows * kUePitch<K, 3>;
  load_tile<kRows, kBcCols, kBcXPitch, kBcThreads>(xs, xb, c * kRows, j0, H, WC, vec);
  load_tile<kRows, kBcCols, kBcXPitch, kBcThreads>(xs + kRows * kBcXPitch, gb, c * kRows, j0, H,
                                                   WC, vec);
}

// grid (ceil(WC / kBcCols), B), kBcThreads threads, kBcSmemBytes<K> of
// dynamic shared memory; x, g, u_re (B, H, WC) bf16; ue (16 ceil(H/8), 6K)
// bf16; sr, si, tr, ti (B, K, WC) f32. vec: x's, g's and u_re's rows are
// 16-byte aligned.
template <int K>
__global__ void __launch_bounds__(kBcThreads, 2)
bwd_contract_kernel_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                       const __nv_bfloat16* __restrict__ ue, const float* __restrict__ sr,
                       const float* __restrict__ si, __nv_bfloat16* __restrict__ u_re,
                       float* __restrict__ tr, float* __restrict__ ti, int H, int WC, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kTM = 2 * K / 16;  // m16 tiles of T'
  constexpr int kRows = kBcRows<K>;
  constexpr int kPitch = kUePitch<K, 3>;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int q = lane >> 3;
  const int r8 = lane & 7;
  const int wcol = (threadIdx.x >> 5) * 16;  // the warp's 16 columns of the strip
  const int j0 = blockIdx.x * kBcCols;
  const int b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * H * WC;
  const int n_chunks = (H + kRows - 1) / kRows;

  bwd_contract_fill<K>(ring, ue, x + base, g + base, 0, j0, H, WC, vec);
  cp_async_commit();
  unsigned sf[3][2 * K / 16][2][2];  // S in three pieces
  load_s_frags<K, 3>(sf, sr, si, b, j0 + wcol, WC);
  float tacc[kTM][2][4];
#pragma unroll
  for (int tm = 0; tm < kTM; ++tm)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tacc[tm][nt][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    __nv_bfloat16* slot = ring + (c & 1) * kBcSlot<K>;
    if (c + 1 < n_chunks)
      bwd_contract_fill<K>(ring + ((c + 1) & 1) * kBcSlot<K>, ue, x + base, g + base, c + 1,
                           j0, H, WC, vec);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed (this thread's pieces)
    __syncthreads();     // everyone's
    const __nv_bfloat16* us = slot;
    __nv_bfloat16* xs = slot + 2 * kRows * kPitch;
    const __nv_bfloat16* gs = xs + kRows * kBcXPitch;
#pragma unroll 1
    for (int mt = 0; mt < kRows / 8; ++mt) {
      float acc[1][2][4] = {};
      rebuild<K, 3, 1, true>(acc, us, mt, sf);
      // u at this lane's pixels (row 8 mt + gq, columns 8 nt + 2 t4 and + 1
      // of the warp's), then the B fragments of T' += Ue^T u: uh/ul[nt][0]
      // rows of u_r, [1] rows of u_i, hi and lo.
      unsigned uh[2][2], ul[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int at = (mt * 8 + gq) * kBcXPitch + wcol + nt * 8 + t4 * 2;
        unsigned* xp = reinterpret_cast<unsigned*>(xs + at);
        const unsigned xw = *xp;
        const unsigned gw = *reinterpret_cast<const unsigned*>(gs + at);
        const float xv[2] = {__uint_as_float(xw << 16), __uint_as_float(xw & 0xffff0000u)};
        const float gv[2] = {__uint_as_float(gw << 16), __uint_as_float(gw & 0xffff0000u)};
        float vr[2], vi[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float zr = xv[e] - acc[0][nt][e];
          const float zi = -acc[0][nt][2 + e];
          const float sq = zr * zr + zi * zi;
          const float coef = sq >= kEps ? gv[e] / sqrtf(fmaxf(sq, kEps)) : 0.f;
          vr[e] = coef * zr;
          vi[e] = coef * zi;
        }
        *xp = bf16x2_bits(__floats2bfloat162_rn(vr[0], vr[1]));
        unsigned p[2];
        split_pair<2>(vr[0], vr[1], p);
        uh[nt][0] = movmatrix_trans(p[0]);
        ul[nt][0] = movmatrix_trans(p[1]);
        split_pair<2>(vi[0], vi[1], p);
        uh[nt][1] = movmatrix_trans(p[0]);
        ul[nt][1] = movmatrix_trans(p[1]);
      }
#pragma unroll
      for (int tm = 0; tm < kTM; ++tm) {
        // A fragment of Ue^T (rows k' = 16 tm.., depth the tile's 16 Ue rows)
        // from the staged Ue, transposed: matrices (e 0-7, k' 0-7),
        // (e 0-7, k' 8-15), (e 8-15, k' 0-7), (e 8-15, k' 8-15).
        unsigned ah[4], al[4];
        const __nv_bfloat16* p =
            us + (16 * mt + r8 + (q >> 1) * 8) * kPitch + 16 * tm + (q & 1) * 8;
        ldmatrix_x4_trans(ah, p);
        ldmatrix_x4_trans(al, p + 2 * K);
        // This k16 step's three products, smallest first, into a zeroed
        // accumulator; then an f32 add rounded to nearest into T' (see
        // rebuild in tc_bf16.cuh): T' sums all of H.
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d, al, uh[nt][0], uh[nt][1]);
          mma_bf16(d, ah, ul[nt][0], ul[nt][1]);
          mma_bf16(d, ah, uh[nt][0], uh[nt][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[tm][nt][e] += d[e];
        }
      }
    }
    __syncthreads();
    store_tile<kRows, kBcCols, kBcXPitch, kBcThreads>(u_re + base, xs, c * kRows, j0, H, WC,
                                                      vec);
    __syncthreads();  // every warp is done with this slot before chunk c + 2 refills it
  }
  // T' rows k' = 16 tm + gq (+ 8): T_r for k' < K, -T_i for the rest. Each
  // quad holds 8 consecutive columns of a row: float2 stores.
  const bool even = (WC & 1) == 0;
#pragma unroll
  for (int tm = 0; tm < kTM; ++tm)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = j0 + wcol + nt * 8 + t4 * 2;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kk = tm * 16 + gq + hh * 8;
        const float sgn = kk < K ? 1.f : -1.f;
        float* p = (kk < K ? tr + (static_cast<size_t>(b) * K + kk) * WC
                           : ti + (static_cast<size_t>(b) * K + kk - K) * WC) + j;
        const float v0 = sgn * tacc[tm][nt][2 * hh];
        const float v1 = sgn * tacc[tm][nt][2 * hh + 1];
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
cudaError_t contract_tc(const void* x, const void* g, const void* ue, const void* sr,
                        const void* si, void* u, void* tr, void* ti, int B, int H, int WC,
                        cudaStream_t s) {
  constexpr int smem = kBcSmemBytes<K>;
  static bool configured[kMaxDevices] = {};  // per device the instantiation runs on
  if (const cudaError_t e = set_smem_once(configured, bwd_contract_kernel_tc<K>, smem);
      e != cudaSuccess)
    return e;
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec =
      WC % 8 == 0 && addr(x) % 16 == 0 && addr(g) % 16 == 0 && addr(u) % 16 == 0;
  const dim3 grid((WC + kBcCols - 1) / kBcCols, B);
  bwd_contract_kernel_tc<K><<<grid, kBcThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(ue), static_cast<const float*>(sr),
      static_cast<const float*>(si), static_cast<__nv_bfloat16*>(u), static_cast<float*>(tr),
      static_cast<float*>(ti), H, WC, vec);
  return cudaGetLastError();
}

cudaError_t launch_contract_bf16(int K, const void* x, const void* g, const void* ue,
                                 const void* sr, const void* si, void* u, void* tr, void* ti,
                                 int B, int H, int WC, cudaStream_t s) {
  switch (K) {
    case 16: return contract_tc<16>(x, g, ue, sr, si, u, tr, ti, B, H, WC, s);
    case 32: return contract_tc<32>(x, g, ue, sr, si, u, tr, ti, B, H, WC, s);
    case 48: return contract_tc<48>(x, g, ue, sr, si, u, tr, ti, B, H, WC, s);
    case 64: return contract_tc<64>(x, g, ue, sr, si, u, tr, ti, B, H, WC, s);
    default: return cudaErrorInvalidValue;
  }
}

// --------------------------------------- kernel 4 on tensor cores (TF32, bf16 model)
//
// dx = u - A R per image with A = [V_r^T | -V_i^T] (H x 2K) and R = [R_r; R_i]
// (2K x WC), each read through its two pointers. A block owns a strip of
// kTcCols columns and walks H in chunks of kTcRowsH rows; warp w owns 16 of
// the strip's columns and holds their R (2K x 16, TF32) as mma B fragments
// in registers for the whole of H. Each chunk's A rows and u tile come by
// cp.async into a 2-slot ring, one chunk ahead of the products
// (mma.m16n8k8, TF32 in, f32 out: 4 x 2 tiles per warp, 2K / 8 steps deep).
constexpr int kTcThreads = 256;        // 8 warps
constexpr int kTcCols = 128;           // columns of the image per block
constexpr int kTcRowsH = 64;           // rows of H per chunk
constexpr int kUPitch = kTcCols + 8;   // bf16 per staged u row: 68 words, = 4 mod 32
template <int K>
constexpr int kAPitch = 2 * K + 4;     // floats per staged A row, = 4 mod 32: an
                                       // A fragment's 32 loads hit 32 banks
template <int K>
constexpr int kASlotBytes = kTcRowsH * kAPitch<K> * 4;
template <int K>
constexpr int kExpandSlotBytes = kASlotBytes<K> + kTcRowsH * kUPitch * 2;
template <int K>
constexpr int kExpandTcSmemBytes = 2 * kExpandSlotBytes<K>;
// Blocks per SM it is compiled for: 2 caps it at 128 registers, which hold
// the R fragments (2K / 2 registers) beside 32 accumulators up to K = 48.
template <int K>
constexpr int kExpandTcBlocks = K <= 48 ? 2 : 1;

// f32 -> TF32 (10 mantissa bits), round to nearest even, as f32 bits with
// the low 13 bits zero; infinities and NaNs pass through.
__device__ __forceinline__ float to_tf32(float v) {
  unsigned u = __float_as_uint(v);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0xfffu + ((u >> 13) & 1u)) & 0xffffe000u;
  return __uint_as_float(u);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fill one ring slot with chunk rows [h0, h0 + kTcRowsH): the A rows by
// cp.async (zeros past H), and the block's u tile, by cp.async where u's
// rows are 16-byte aligned (vec) and the piece lies inside the row, element
// by element where not (zeros past H and WC).
template <int K>
__device__ __forceinline__ void expand_slot(unsigned char* slot, const float* __restrict__ vr_t,
                                            const float* __restrict__ vi_t,
                                            const __nv_bfloat16* __restrict__ ub, int h0, int j0,
                                            int H, int WC, bool vec) {
  float* as = reinterpret_cast<float*>(slot);
  constexpr int kAPieces = kTcRowsH * 2 * K / 4;
  for (int i = threadIdx.x; i < kAPieces; i += kTcThreads) {
    const int r = i / (2 * K / 4);
    const int c = (i % (2 * K / 4)) * 4;
    const int h = h0 + r;
    const float* src = c < K ? vr_t + static_cast<size_t>(h) * K + c
                             : vi_t + static_cast<size_t>(h) * K + (c - K);
    cp_async16(as + r * kAPitch<K> + c, h < H ? src : vr_t, h < H ? 16 : 0);
  }
  __nv_bfloat16* us = reinterpret_cast<__nv_bfloat16*>(slot + kASlotBytes<K>);
  constexpr int kUPieces = kTcRowsH * kTcCols / 8;
  for (int i = threadIdx.x; i < kUPieces; i += kTcThreads) {
    const int r = i / (kTcCols / 8);
    const int c = (i % (kTcCols / 8)) * 8;
    const int h = h0 + r;
    const int j = j0 + c;
    __nv_bfloat16* dst = us + r * kUPitch + c;
    const __nv_bfloat16* src = ub + static_cast<size_t>(h) * WC + j;
    if (h >= H || j >= WC) {
      cp_async16(dst, ub, 0);
    } else if (vec && j + 8 <= WC) {
      cp_async16(dst, src, 16);
    } else {
      for (int e = 0; e < 8; ++e) dst[e] = j + e < WC ? src[e] : __float2bfloat16(0.f);
    }
  }
}

// The A pieces this thread copied into a slot, rewritten in place as TF32
// with the imaginary half negated; called once they have landed.
template <int K>
__device__ __forceinline__ void round_a(unsigned char* slot) {
  float* as = reinterpret_cast<float*>(slot);
  constexpr int kAPieces = kTcRowsH * 2 * K / 4;
  for (int i = threadIdx.x; i < kAPieces; i += kTcThreads) {
    const int r = i / (2 * K / 4);
    const int c = (i % (2 * K / 4)) * 4;
    float4* p = reinterpret_cast<float4*>(as + r * kAPitch<K> + c);
    const float4 v = *p;
    const float sgn = c < K ? 1.f : -1.f;
    *p = make_float4(to_tf32(sgn * v.x), to_tf32(sgn * v.y), to_tf32(sgn * v.z),
                     to_tf32(sgn * v.w));
  }
}

// grid (ceil(WC / kTcCols), B), kTcThreads threads, kExpandTcSmemBytes<K>
// of dynamic shared memory; vr_t, vi_t (H, K) f32; rr, ri (B, K, WC) f32;
// u_re, dx (B, H, WC) bf16. vec: u's and dx's rows are 16-byte aligned.
template <int K>
__global__ void __launch_bounds__(kTcThreads, kExpandTcBlocks<K>)
bwd_expand_kernel_tc(const float* __restrict__ vr_t, const float* __restrict__ vi_t,
                     const float* __restrict__ rr, const float* __restrict__ ri,
                     const __nv_bfloat16* __restrict__ u_re, __nv_bfloat16* __restrict__ dx,
                     int H, int WC, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kSteps = 2 * K / 8;  // k8 steps over the stacked 2K
  const int lane = threadIdx.x & 31;
  const int wcol = (threadIdx.x >> 5) * 16;  // the warp's 16 columns of the strip
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int j0 = blockIdx.x * kTcCols;
  const int b = blockIdx.y;
  const int n_chunks = (H + kTcRowsH - 1) / kTcRowsH;
  const size_t base = static_cast<size_t>(b) * H * WC;

  expand_slot<K>(smem_raw, vr_t, vi_t, u_re + base, 0, j0, H, WC, vec);
  cp_async_commit();
  // This warp's R as B fragments: b0 = R[8s + t4][n], b1 = R[8s + t4 + 4][n]
  // for the columns n = g of its two n8 tiles; zeros past WC.
  unsigned rf[kSteps][2][2];
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 8 * s + t4 + 4 * e;
        const int j = j0 + wcol + nt * 8 + g;
        const float* row = kk < K ? rr + (static_cast<size_t>(b) * K + kk) * WC
                                  : ri + (static_cast<size_t>(b) * K + kk - K) * WC;
        rf[s][nt][e] = __float_as_uint(to_tf32(j < WC ? __ldg(row + j) : 0.f));
      }

  for (int c = 0; c < n_chunks; ++c) {
    unsigned char* slot = smem_raw + (c & 1) * kExpandSlotBytes<K>;
    if (c + 1 < n_chunks)
      expand_slot<K>(smem_raw + ((c + 1) & 1) * kExpandSlotBytes<K>, vr_t, vi_t, u_re + base,
                     (c + 1) * kTcRowsH, j0, H, WC, vec);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed (this thread's pieces)
    round_a<K>(slot);
    __syncthreads();     // everyone's pieces, rounded

    const float* as = reinterpret_cast<const float*>(slot);
    float acc[4][2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // A fragment: a0 = A[g][t4], a1 = A[g + 8][t4], a2 = A[g][t4 + 4],
        // a3 = A[g + 8][t4 + 4] of the m16 x k8 tile.
        const float* ap = as + (mt * 16 + g) * kAPitch<K> + 8 * s + t4;
        const unsigned af[4] = {__float_as_uint(ap[0]), __float_as_uint(ap[8 * kAPitch<K>]),
                                __float_as_uint(ap[4]),
                                __float_as_uint(ap[8 * kAPitch<K> + 4])};
        mma_tf32(acc[mt][0], af, rf[s][0][0], rf[s][0][1]);
        mma_tf32(acc[mt][1], af, rf[s][1][0], rf[s][1][1]);
      }

    // dx = u - acc at this lane's accumulator positions (rows g and g + 8 of
    // each m16 tile, columns 2 t4 and 2 t4 + 1 of each n8 tile), written
    // over u in the slot; then the tile goes out in 16-byte pieces.
    __nv_bfloat16* us = reinterpret_cast<__nv_bfloat16*>(slot + kASlotBytes<K>);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          unsigned* p = reinterpret_cast<unsigned*>(us + (mt * 16 + g + hh * 8) * kUPitch +
                                                    wcol + nt * 8 + t4 * 2);
          const unsigned w = *p;
          const __nv_bfloat162 d = __floats2bfloat162_rn(
              __uint_as_float(w << 16) - acc[mt][nt][2 * hh],
              __uint_as_float(w & 0xffff0000u) - acc[mt][nt][2 * hh + 1]);
          *p = *reinterpret_cast<const unsigned*>(&d);
        }
    __syncthreads();
    constexpr int kUPieces = kTcRowsH * kTcCols / 8;
    for (int i = threadIdx.x; i < kUPieces; i += kTcThreads) {
      const int r = i / (kTcCols / 8);
      const int cc = (i % (kTcCols / 8)) * 8;
      const int h = c * kTcRowsH + r;
      const int j = j0 + cc;
      if (h >= H || j >= WC) continue;
      const __nv_bfloat16* src = us + r * kUPitch + cc;
      __nv_bfloat16* dst = dx + base + static_cast<size_t>(h) * WC + j;
      if (vec && j + 8 <= WC) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && j + e < WC; ++e) dst[e] = src[e];
      }
    }
    __syncthreads();  // every warp is done with this slot before chunk c + 2 refills it
  }
}

template <int K>
cudaError_t expand_tc(const void* vr_t, const void* vi_t, const void* rr, const void* ri,
                      const void* u, void* dx, int B, int H, int WC, cudaStream_t s) {
  constexpr int smem = kExpandTcSmemBytes<K>;
  static bool configured[kMaxDevices] = {};  // per device the instantiation runs on
  if (const cudaError_t e = set_smem_once(configured, bwd_expand_kernel_tc<K>, smem);
      e != cudaSuccess)
    return e;
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = WC % 8 == 0 && addr(u) % 16 == 0 && addr(dx) % 16 == 0;
  const dim3 grid((WC + kTcCols - 1) / kTcCols, B);
  bwd_expand_kernel_tc<K><<<grid, kTcThreads, smem, s>>>(
      static_cast<const float*>(vr_t), static_cast<const float*>(vi_t),
      static_cast<const float*>(rr), static_cast<const float*>(ri),
      static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(dx), H, WC, vec);
  return cudaGetLastError();
}

// bf16: the TF32 tensor-core kernel; float32: the CUDA-core kernel, exact f32.
cudaError_t launch_expand_bf16(int K, const void* vr_t, const void* vi_t, const void* rr,
                               const void* ri, const void* u, void* dx, int B, int H, int WC,
                               cudaStream_t s) {
  switch (K) {
    case 16: return expand_tc<16>(vr_t, vi_t, rr, ri, u, dx, B, H, WC, s);
    case 32: return expand_tc<32>(vr_t, vi_t, rr, ri, u, dx, B, H, WC, s);
    case 48: return expand_tc<48>(vr_t, vi_t, rr, ri, u, dx, B, H, WC, s);
    case 64: return expand_tc<64>(vr_t, vi_t, rr, ri, u, dx, B, H, WC, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_expand_f32(int K, const void* vr_t, const void* vi_t, const void* rr,
                              const void* ri, const void* u, void* dx, int B, int H, int WC,
                              cudaStream_t s) {
  const dim3 grid((WC + kThreads - 1) / kThreads, B);
  const float* a = static_cast<const float*>(vr_t);
  const float* c = static_cast<const float*>(vi_t);
  const float* p = static_cast<const float*>(rr);
  const float* q = static_cast<const float*>(ri);
  const float* up = static_cast<const float*>(u);
  float* o = static_cast<float*>(dx);
  switch (K) {
    case 16: bwd_expand_kernel<16><<<grid, kThreads, 0, s>>>(a, c, p, q, up, o, H, WC); break;
    case 32: bwd_expand_kernel<32><<<grid, kThreads, 0, s>>>(a, c, p, q, up, o, H, WC); break;
    case 48: bwd_expand_kernel<48><<<grid, kThreads, 0, s>>>(a, c, p, q, up, o, H, WC); break;
    case 64: bwd_expand_kernel<64><<<grid, kThreads, 0, s>>>(a, c, p, q, up, o, H, WC); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16, the type of x, g, u_re and dx.
// ue: the stacked, split U_H of tc_bf16.cuh, read by the bf16 kernel only.
extern "C" int eelunet_highpass_bwd_contract(int dtype, int K, const void* x, const void* g,
                                             const void* ur, const void* ui, const void* ue,
                                             const void* sr, const void* si, void* u_re,
                                             void* tr, void* ti, int B, int H, int WC,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_contract_f32(K, x, g, ur, ui, sr, si, u_re, tr, ti, B, H, WC, s);
  if (dtype == 1) return launch_contract_bf16(K, x, g, ue, sr, si, u_re, tr, ti, B, H, WC, s);
  return cudaErrorInvalidValue;
}

extern "C" int eelunet_highpass_bwd_expand(int dtype, int K, const void* vr_t,
                                           const void* vi_t, const void* rr, const void* ri,
                                           const void* u_re, void* dx, int B, int H, int WC,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_expand_f32(K, vr_t, vi_t, rr, ri, u_re, dx, B, H, WC, s);
  if (dtype == 1) return launch_expand_bf16(K, vr_t, vi_t, rr, ri, u_re, dx, B, H, WC, s);
  return cudaErrorInvalidValue;
}

// Kernels of this library whose shared-memory attribute is set on device
// `dev` (one per instantiation launched there).
extern "C" int eelunet_highpass_bwd_configured(int dev) { return configured_on(dev); }
