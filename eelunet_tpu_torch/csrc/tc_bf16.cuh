// bf16 tensor-core pieces shared by the kernels of highpass.cu and
// highpass_bwd.cu: ldmatrix, mma.sync.m16n8k16 (bf16 in, f32 sums),
// movmatrix, the split of f32 values into bf16 pieces, and the rebuild of
// the low-pass rows lr + i li = U_H S that kernels 2 and 3 share.
//
// The split: an f32 value v is cut into bf16 pieces, each rounded to
// nearest even from what the earlier ones left: p0 = bf16(v), p1 = bf16(v -
// p0), p2 = bf16(v - p0 - p1) (0 where p0 is infinite, so infinities and
// NaNs pass through p0). p0 + p1 keeps 16 of f32's 24 bits (within 2^-16
// of v), p0 + p1 + p2 all of them. A product a b is taken, each term exact
// in f32 and summed in f32, as
//   bf16x3 (2 pieces): a0 b0 + a0 b1 + a1 b0, within about 2^-16 of a b;
//   bf16x6 (3 pieces): those + a0 b2 + a2 b0 + a1 b1, within about 2^-24.
//
// The stacked factor Ue, made once with the factors (ops/fft_cuda.py
// uh_stacked): (16 ceil(H/8), 6K) bf16. Rows come in groups of 16 per 8
// rows of H: row 16 g + r holds, for h = 8 g + r, A_re[h] = [U_r[h] | -U_i[h]]
// (r < 8) or A_im[h - 8] = [U_i | U_r] (r >= 8); columns [2K p, 2K (p + 1))
// hold piece p; rows of h >= H are 0. So one m16 tile of the rebuild's
// product holds lr (rows g) and li (rows g + 8) of the same 8 rows of H,
// and each lane's accumulators give lr and li of the same two pixels.
#pragma once

#include <cuda_bf16.h>

#include "async_copy.cuh"

// bf16 per staged Ue row holding kPieces pieces: 2K kPieces + 8, which is
// 4 words mod 16 for every K, so the 8 rows one ldmatrix reads hit 32 banks.
template <int K, int kPieces>
constexpr int kUePitch = 2 * K * kPieces + 8;

// Four 8x8 b16 matrices: lane l gives the row address of matrix l / 8, row l % 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An 8x8 b16 matrix held as a fragment (lane l: row l / 4, columns 2 (l % 4)
// and 2 (l % 4) + 1), transposed across the warp.
__device__ __forceinline__ unsigned movmatrix_trans(unsigned a) {
  unsigned d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float rest(float v, float h) {
  return (__float_as_uint(h) & 0x7f800000u) == 0x7f800000u ? 0.f : v - h;
}

// (v0, v1) -> kPieces packed bf16 pairs, v0 in the low halves.
template <int kPieces>
__device__ __forceinline__ void split_pair(float v0, float v1, unsigned (&p)[kPieces]) {
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    p[i] = bf16x2_bits(h);
    v0 = rest(v0, __low2float(h));
    v1 = rest(v1, __high2float(h));
  }
}

// Lane (g = lane / 4, t4 = lane % 4) of a warp that owns the 16 columns
// [jw, jw + 16): its B fragments of the stacked spectrum [S_r; S_i]
// (2K x WC), split: s[p][ks][nt][e] holds piece p of rows 16 ks + 8 e + 2 t4
// and + 1 of column jw + 8 nt + g. Zeros past WC.
template <int K, int kPieces>
__device__ __forceinline__ void load_s_frags(unsigned (&s)[kPieces][2 * K / 16][2][2],
                                             const float* __restrict__ sr,
                                             const float* __restrict__ si, int b, int jw,
                                             int WC) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2 * K / 16; ++ks)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 16 * ks + 8 * e + 2 * t4;  // kk and kk + 1 lie in one half
        const int j = jw + nt * 8 + g;
        const float* row = kk < K ? sr + (static_cast<size_t>(b) * K + kk) * WC
                                  : si + (static_cast<size_t>(b) * K + kk - K) * WC;
        unsigned p[kPieces];
        split_pair<kPieces>(j < WC ? __ldg(row + j) : 0.f, j < WC ? __ldg(row + WC + j) : 0.f,
                            p);
#pragma unroll
        for (int i = 0; i < kPieces; ++i) s[i][ks][nt][e] = p[i];
      }
}

// Stage the first kPieces pieces of the Ue rows of 8-row groups [grp0,
// grp0 + kGroups) into shared rows of kUePitch<K, kPieces> bf16 by 16-byte
// cp.async; zeros past the n_groups there are.
template <int K, int kPieces, int kGroups, int kThreads>
__device__ __forceinline__ void load_ue(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ ue,
                                        int grp0, int n_groups) {
  constexpr int kRowPieces = 2 * K * kPieces / 8;
  constexpr int kCopies = kGroups * 16 * kRowPieces;
  for (int i = threadIdx.x; i < kCopies; i += kThreads) {
    const int r = i / kRowPieces;
    const int c = (i % kRowPieces) * 8;
    const bool in = grp0 + r / 16 < n_groups;
    cp_async16(dst + r * kUePitch<K, kPieces> + c,
               in ? ue + (static_cast<size_t>(grp0) * 16 + r) * 6 * K + c : ue, in ? 16 : 0);
  }
}

// Stage rows [h0, h0 + kRows) x columns [j0, j0 + kCols) of one (H, WC)
// bf16 image into shared rows of kPitch: 16-byte cp.async where the image's
// rows are 16-byte aligned (vec) and the piece lies inside the row, element
// by element where not; zeros past H and WC.
template <int kRows, int kCols, int kPitch, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                          int h0, int j0, int H, int WC, bool vec) {
  constexpr int kPieces = kRows * kCols / 8;
  for (int i = threadIdx.x; i < kPieces; i += kThreads) {
    const int r = i / (kCols / 8);
    const int c = (i % (kCols / 8)) * 8;
    const int h = h0 + r;
    const int j = j0 + c;
    __nv_bfloat16* d = dst + r * kPitch + c;
    const __nv_bfloat16* s = src + static_cast<size_t>(h) * WC + j;
    if (h >= H || j >= WC) {
      cp_async16(d, src, 0);
    } else if (vec && j + 8 <= WC) {
      cp_async16(d, s, 16);
    } else {
      for (int e = 0; e < 8; ++e) d[e] = j + e < WC ? s[e] : __float2bfloat16(0.f);
    }
  }
}

// The inverse: rows [h0, h0 + kRows) x columns [j0, j0 + kCols) of shared
// memory out to the image, 16 bytes at a time where aligned, inside H and WC.
template <int kRows, int kCols, int kPitch, int kThreads>
__device__ __forceinline__ void store_tile(__nv_bfloat16* __restrict__ dst,
                                           const __nv_bfloat16* src, int h0, int j0, int H,
                                           int WC, bool vec) {
  constexpr int kPieces = kRows * kCols / 8;
  for (int i = threadIdx.x; i < kPieces; i += kThreads) {
    const int r = i / (kCols / 8);
    const int c = (i % (kCols / 8)) * 8;
    const int h = h0 + r;
    const int j = j0 + c;
    if (h >= H || j >= WC) continue;
    const __nv_bfloat16* s = src + r * kPitch + c;
    __nv_bfloat16* d = dst + static_cast<size_t>(h) * WC + j;
    if (vec && j + 8 <= WC) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < 8 && j + e < WC; ++e) d[e] = s[e];
    }
  }
}

// lr and li of kM m16 tiles (8 rows of H each) from the staged Ue rows
// (kPieces pieces) at the warp's 16 columns, in bf16x3 (kPieces = 2) or
// bf16x6 (3): acc[m][nt][0..1] = lr and acc[m][nt][2..3] = li of rows
// 8 (mt0 + m) + g of the chunk, columns 8 nt + 2 t4 and + 1 of the warp's.
// Added into acc.
//
// The tensor cores add into their f32 accumulator with truncation, about
// one unit in the last place of the running sum per mma; over a chain of
// mmas into one accumulator that adds up. kRn: each k16 step's products go
// into a zeroed accumulator, smallest first, and that partial sum joins acc
// by an f32 add rounded to nearest, so the rebuild keeps the precision of
// its pieces.
template <int K, int kPieces, int kM, bool kRn>
__device__ __forceinline__ void rebuild(float (&acc)[kM][2][4], const __nv_bfloat16* us, int mt0,
                                        const unsigned (&s)[kPieces][2 * K / 16][2][2]) {
  // Products, largest first: (piece of U, piece of S) = (0,0), (0,1), (1,0),
  // then for bf16x6 (0,2), (2,0), (1,1).
  constexpr int kTerms = kPieces == 2 ? 3 : 6;
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3;
  const int r8 = lane & 7;
#pragma unroll
  for (int ks = 0; ks < 2 * K / 16; ++ks)
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      unsigned a[kPieces][4];
      const __nv_bfloat16* p = us + (16 * (mt0 + m) + (q & 1) * 8 + r8) * kUePitch<K, kPieces> +
                               16 * ks + (q >> 1) * 8;
#pragma unroll
      for (int i = 0; i < kPieces; ++i) ldmatrix_x4(a[i], p + 2 * K * i);
      if constexpr (kRn) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int t = kTerms - 1; t >= 0; --t) {
            const int pa = t == 2 || t == 5 ? 1 : t == 4 ? 2 : 0;
            const int pb = t == 1 || t == 5 ? 1 : t == 3 ? 2 : 0;
            mma_bf16(d, a[pa], s[pb][ks][nt][0], s[pb][ks][nt][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][nt][e] += d[e];
        }
      } else {
#pragma unroll
        for (int t = 0; t < kTerms; ++t) {
          const int pa = t == 2 || t == 5 ? 1 : t == 4 ? 2 : 0;
          const int pb = t == 1 || t == 5 ? 1 : t == 3 ? 2 : 0;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_bf16(acc[m][nt], a[pa], s[pb][ks][nt][0], s[pb][ks][nt][1]);
        }
      }
    }
}
