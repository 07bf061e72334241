// FFT high-pass backward kernel pair for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels of eelunet_tpu/ops/fft_pallas.py:
//   bwd_contract_kernel <- _bwd_contract_kernel (:390)
//   bwd_expand_kernel   <- _bwd_expand_kernel   (:427)
// both launched there by _bwd_core (:453). With x and the cotangent g viewed
// as (B, H, W*C) and S the saved skinny spectrum of the forward:
//   contract:  z = x - U_H S (complex, rebuilt per column from S);
//              u = g z / |z|, 0 where |z|^2 < 1e-24 (the forward's clamp);
//              writes Re u in the model type and T = U_H^T conj(u),
//              (B, K, W*C) f32, accumulated from the unrounded f32 u.
//   expand:    dx = f32(Re u) - Re(V_H^T R), rounded to the model type, where
//              R is T after the W-axis middle (four skinny einsums, in PyTorch).
// x, g, u and dx share one type, f32 or bf16: autograd hands the backward a
// cotangent in its output's type, which is x's.
// All arithmetic is f32; U_H, V_H^T, S and R are f32 (the semantics of
// _bwd_core, not of _highpass_bwd_impl, which casts U_H to the model type).
//
// What bounds it on an H100: at the training sites, (8,256,256,128) and
// (8,512,512,64) in bf16 with m = 20 (K = 48), the contract reads x, g and S
// and writes u and T (1.01 GB at the 512 site, 0.30 ms at 3.35 TB/s) and does
// 8K FMAs per element (5.2e10); the expand reads R and u and writes dx
// (0.64 GB, 0.19 ms) with 2K FMAs per element. On CUDA cores in f32 both are
// compute-bound, as the forward pair is. The design follows the forward
// kernels (csrc/highpass.cu):
//   - one thread owns one column j of the (H, W*C) image and each block walks
//     the whole of H, so T's sum over H stays in one thread: no atomics and no
//     second pass. Any H and any W*C are taken (the ragged edge is masked), so
//     there is no shape fallback;
//   - the factor rows (U_H for the contract, V_H^T for the expand) are staged
//     in shared memory 32 rows at a time and read as float4 broadcasts.
// The contract needs the column's S (2K values) to rebuild z and the 2K
// accumulators of T at once: 192 values at K = 48, against 255 registers a
// thread. T stays in registers; the block's S columns go to dynamic shared
// memory as float4s laid out [k/4][thread], so a warp's reads are 512
// consecutive bytes, conflict-free (48 KB at K = 48, 64 KB at K = 64, plus
// the staged rows; above 48 KB after cudaFuncSetAttribute). ptxas' report
// (chip_smoke.py phase 2) decided the rest: with the rebuild loop fully
// unrolled the compiler hoisted every load of S and U ahead and hit 255
// registers with ~470 bytes of spills at K = 48 (9.6 ms at the 512 site on
// an H100 at 700 W); unrolled by 2 and compiled for 3 blocks per SM it takes
// 168 registers, spills nothing, and runs in 5.3 ms. What is left bounding
// it is shared memory: per row a warp reads its S (96 wavefronts) and the U
// row twice as float4 broadcasts (48 loads of 4 wavefronts), about 290
// cycles against 96 cycles of FMAs. The other design, T's K split across
// blockIdx.z with z recomputed per split, would add 4K FMAs per element for
// each extra split; it was not chosen.
//
// Interface: plain C functions, loaded with ctypes. Each launches on the
// stream it is given and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // columns per block
constexpr int kRows = 32;      // factor rows staged in shared memory per step
constexpr float kEps = 1e-24f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

// grid (ceil(WC / kThreads), B); x, g, u_re (B, H, WC) in T; ur, ui (H, K)
// f32; sr, si (B, K, WC) f32; tr, ti (B, K, WC) f32.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, kContractBlocks<K>)
bwd_contract_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ ur, const float* __restrict__ ui,
                    const float* __restrict__ sr, const float* __restrict__ si,
                    T* __restrict__ u_re, float* __restrict__ tr, float* __restrict__ ti,
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
        const float zr = to_f32(x[at]) - (rr - ii);
        const float zi = -(ri + ir);
        const float sq = zr * zr + zi * zi;
        const float coef = sq >= kEps ? to_f32(g[at]) / sqrtf(fmaxf(sq, kEps)) : 0.f;
        const float vr = coef * zr;
        const float vi = coef * zi;
        store(u_re + at, vr);
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

// grid (ceil(WC / kThreads), B); vr_t, vi_t (H, K) f32; rr, ri (B, K, WC) f32;
// u_re, dx (B, H, WC) in T.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
bwd_expand_kernel(const float* __restrict__ vr_t, const float* __restrict__ vi_t,
                  const float* __restrict__ rr, const float* __restrict__ ri,
                  const T* __restrict__ u_re, T* __restrict__ dx, int H, int WC) {
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
        store(dx + at, to_f32(u_re[at]) - ((p0 + p1) - (n0 + n1)));
      }
    }
  }
}

template <typename T, int K>
cudaError_t contract_k(const void* x, const void* g, const void* ur, const void* ui,
                       const void* sr, const void* si, void* u, void* tr, void* ti, int B,
                       int H, int WC, cudaStream_t s) {
  constexpr int smem = contract_smem_bytes<K>();
  static bool configured = false;  // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_contract_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((WC + kThreads - 1) / kThreads, B);
  bwd_contract_kernel<T, K><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(ur),
      static_cast<const float*>(ui), static_cast<const float*>(sr),
      static_cast<const float*>(si), static_cast<T*>(u), static_cast<float*>(tr),
      static_cast<float*>(ti), H, WC);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_contract(int K, const void* x, const void* g, const void* ur,
                            const void* ui, const void* sr, const void* si, void* u,
                            void* tr, void* ti, int B, int H, int WC, cudaStream_t s) {
  switch (K) {
    case 16: return contract_k<T, 16>(x, g, ur, ui, sr, si, u, tr, ti, B, H, WC, s);
    case 32: return contract_k<T, 32>(x, g, ur, ui, sr, si, u, tr, ti, B, H, WC, s);
    case 48: return contract_k<T, 48>(x, g, ur, ui, sr, si, u, tr, ti, B, H, WC, s);
    case 64: return contract_k<T, 64>(x, g, ur, ui, sr, si, u, tr, ti, B, H, WC, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_expand(int K, const void* vr_t, const void* vi_t, const void* rr,
                          const void* ri, const void* u, void* dx, int B, int H, int WC,
                          cudaStream_t s) {
  const dim3 grid((WC + kThreads - 1) / kThreads, B);
  const float* a = static_cast<const float*>(vr_t);
  const float* c = static_cast<const float*>(vi_t);
  const float* p = static_cast<const float*>(rr);
  const float* q = static_cast<const float*>(ri);
  const T* up = static_cast<const T*>(u);
  T* o = static_cast<T*>(dx);
  switch (K) {
    case 16: bwd_expand_kernel<T, 16><<<grid, kThreads, 0, s>>>(a, c, p, q, up, o, H, WC); break;
    case 32: bwd_expand_kernel<T, 32><<<grid, kThreads, 0, s>>>(a, c, p, q, up, o, H, WC); break;
    case 48: bwd_expand_kernel<T, 48><<<grid, kThreads, 0, s>>>(a, c, p, q, up, o, H, WC); break;
    case 64: bwd_expand_kernel<T, 64><<<grid, kThreads, 0, s>>>(a, c, p, q, up, o, H, WC); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16, the type of x, g, u_re and dx.
extern "C" int eelunet_highpass_bwd_contract(int dtype, int K, const void* x, const void* g,
                                             const void* ur, const void* ui, const void* sr,
                                             const void* si, void* u_re, void* tr, void* ti,
                                             int B, int H, int WC, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_contract<float>(K, x, g, ur, ui, sr, si, u_re, tr, ti, B, H, WC, s);
  if (dtype == 1)
    return launch_contract<__nv_bfloat16>(K, x, g, ur, ui, sr, si, u_re, tr, ti, B, H, WC, s);
  return cudaErrorInvalidValue;
}

extern "C" int eelunet_highpass_bwd_expand(int dtype, int K, const void* vr_t,
                                           const void* vi_t, const void* rr, const void* ri,
                                           const void* u_re, void* dx, int B, int H, int WC,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_expand<float>(K, vr_t, vi_t, rr, ri, u_re, dx, B, H, WC, s);
  if (dtype == 1)
    return launch_expand<__nv_bfloat16>(K, vr_t, vi_t, rr, ri, u_re, dx, B, H, WC, s);
  return cudaErrorInvalidValue;
}
