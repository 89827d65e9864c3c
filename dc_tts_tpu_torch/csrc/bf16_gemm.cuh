// The bf16 tensor-core GEMM block of X1 (csrc/ct_fwd.cu; its tile sizes
// keep the K3_ names of the round kernel that first used it):
// mma.sync.m16n8k16 with float32 sums on 128 x 128 x 32
// block tiles, 8 warps of 64 x 32, one shared-memory stage refilled from
// registers that were loaded during the previous stage's products. The A
// tile loader reads float32 through a caller's fetch and rounds it to bf16
// (to nearest even) on its way to shared memory, with THREE also the lo
// half of a hi/lo split; B is a constant matrix stored bf16, n rows with k
// contiguous. Also the m16n8k16 fragment loaders, for any row pitch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define K3_BM 128
#define K3_BN 128
#define K3_BK 32
#define K3_LDS 40  // shared row pitch in bf16 (80 B): conflict-free fragments
#define K3_NT 256

namespace {

typedef __nv_bfloat16 bf16;

struct __align__(16) Tiles {
  bf16 a[2][K3_BM][K3_LDS];  // A tile, hi and lo, k contiguous
  bf16 b[2][K3_BN][K3_LDS];  // B tile, hi and lo, n rows, k contiguous
};

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a @ b on one m16n8k16 fragment set
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment: rows r, r+8; columns k, k+1 and k+8, k+9 (k = ks + 2*(lane%4))
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], bf16 (*s)[LD], int r,
                                       int k) {
  a[0] = lds32(&s[r][k]);
  a[1] = lds32(&s[r + 8][k]);
  a[2] = lds32(&s[r][k + 8]);
  a[3] = lds32(&s[r + 8][k + 8]);
}

// B fragment: column c (a row of the n-major tile); k, k+1 and k+8, k+9
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], bf16 (*s)[LD], int c,
                                       int k) {
  b[0] = lds32(&s[c][k]);
  b[1] = lds32(&s[c][k + 8]);
}

// The block's 128 x 128 tile of A @ B^T into acc. Warp w holds rows
// (w/4)*64 + [0, 64) and columns (w%4)*32 + [0, 32) as 4 x 4 m16n8
// fragments. fetch(i, k) gives A's float32 elements (row, k), (row, k+1) for
// row = 16*i + threadIdx.x/16 of the tile, zero outside A. whi/wlo: B's
// first row of the tile, ldb elements per row; K is a multiple of K3_BK and
// B holds every row the tile reads. Each k-tile's products are summed on the
// tensor cores from zero and then added to acc on the CUDA cores: one long
// tensor-core accumulation would truncate every partial sum, the short one
// keeps the error near a float32 dot product's.
template <bool THREE, class Fetch>
__device__ __forceinline__ void gemm_block(Fetch fetch,
                                           const bf16* __restrict__ whi,
                                           const bf16* __restrict__ wlo,
                                           int ldb, int K, Tiles& sm,
                                           float (&acc)[4][4][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int ar = tid >> 4, ac = (tid & 15) * 2;  // A: rows ar + 16i, 2 cols
  const int br = tid >> 2, bc = (tid & 3) * 8;   // B: rows br, br+64, 8 cols
  float2 ra[8];
  uint4 rh[2], rl[2];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) ra[i] = fetch(i, k0 + ac);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t o = (size_t)(br + 64 * i) * ldb + k0 + bc;
      rh[i] = *reinterpret_cast<const uint4*>(whi + o);
      if (THREE) rl[i] = *reinterpret_cast<const uint4*>(wlo + o);
    }
  };

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += K3_BK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(ra[i].x, ra[i].y);
      *reinterpret_cast<__nv_bfloat162*>(&sm.a[0][ar + 16 * i][ac]) = hi;
      if (THREE)
        *reinterpret_cast<__nv_bfloat162*>(&sm.a[1][ar + 16 * i][ac]) =
            __floats2bfloat162_rn(ra[i].x - __low2float(hi),
                                  ra[i].y - __high2float(hi));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(&sm.b[0][br + 64 * i][bc]) = rh[i];
      if (THREE) *reinterpret_cast<uint4*>(&sm.b[1][br + 64 * i][bc]) = rl[i];
    }
    __syncthreads();
    if (k0 + K3_BK < K) load(k0 + K3_BK);  // in flight during the products

    float part[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < K3_BK; ks += 16) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        frag_b(bh[nt], sm.b[0], wn + nt * 8 + g, ks + t2);
        if (THREE) frag_b(bl[nt], sm.b[1], wn + nt * 8 + g, ks + t2);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t ah[4], al[4];
        frag_a(ah, sm.a[0], wm + mt * 16 + g, ks + t2);
        if (THREE) frag_a(al, sm.a[1], wm + mt * 16 + g, ks + t2);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_bf16(part[mt][nt], ah, bh[nt]);
          if (THREE) {
            mma_bf16(part[mt][nt], ah, bl[nt]);
            mma_bf16(part[mt][nt], al, bh[nt]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[mt][nt][q];
    __syncthreads();
  }
}

}  // namespace
