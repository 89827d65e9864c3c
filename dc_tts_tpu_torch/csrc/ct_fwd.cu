// Kernels X1-X4: the forward-rDFT prototypes of scripts/ct_kernel_exp.py.
//
// Replaces scripts/ct_kernel_exp.py's full_fwd (X1, _full_kernel),
// fact_fwd_tiled (X2, _fact_tiled_kernel), fact_fwd (X3, _fact_kernel) and
// ablate_fwd (X4, _ablate_kernel). The design note is in
// dc_tts_tpu_torch/ops/ct_fwd.py. Frames x are (F, 2048) float32.
//
//   dctts_ct_full  X1: [Xr | Xi] = x @ [CF, SF], a GEMM M = F, K = 2048,
//                  N = 2*1025 with CF and SF interleaved as columns (2k,
//                  2k+1), so each thread's accumulator pair is one bin.
//                  bf16: csrc/bf16_gemm.cuh's tensor-core block, its loader
//                  rounding x to bf16 (to nearest even); float32: a SIMT
//                  SGEMM (FFMA, no TF32), 128 x 128 x 8 tiles, 8 x 8
//                  outputs a thread, sums promoted every 64 products.
//   dctts_ct_fact  X2, X3 and X4: the 16 x 128 factored DFT,
//                  n = 128*n1 + n2, k = k1 + 16*k2, output (16, F, 128):
//                    T  x[f, n1, n2] read as (n1, f, n2) (without T: the
//                       tile's memory reinterpreted, the script's reshape)
//                    A  g[k1] = sum_n1 (C16 + i S16)[k1, n1] x[n1]  (FFMA)
//                    W  z = g * (Tc + i Ts)[k1, n2]                 (FFMA)
//                    C  X[k1, f, :] = z[k1, f, :] @ (C128 + i S128), as
//                       Xr = zr@C - zi@S, Xi = zr@S + zi@C (K = 128 each):
//                       bf16 mma.sync with z rounded to bf16, or FFMA
//                  A block keeps C128 and S128 in shared memory and walks
//                  over groups of 4 frames: 64 (k1, frame) rows. Stages T,
//                  A and W run one thread per (frame, n2) straight from
//                  device memory into shared z; stage C is the block's
//                  64 x 128 x 128 products; each (k1, f) output row of 128
//                  k2 is written contiguous. The stage bits are template
//                  arguments, so a stage that is off costs no instruction.
//
// What bounds them on the H100: X1 its operations (7.05 GFLOP at F = 840:
// 105 us float32, 7.1 us bf16); the factored form needs 2.24 MFLOP a
// frame, mostly stage C (3.7x fewer than X1), so in bf16 its bytes (x read
// once, all 2048 bins of Xr and Xi written once: 6.2 us at F = 840) and in
// float32 its operations (28 us). Not yet done: wgmma, cp.async/TMA
// pipelining, and stage C's N = 2 x 128 as one product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_gemm.cuh"  // gemm_block, Tiles, mma_bf16, frag_a, frag_b

namespace {

constexpr int NFFT = 2048, NBIN = NFFT / 2 + 1;
constexpr int CT_N1 = 16, CT_N2 = 128;
constexpr int FB = 4;                // frames per group
constexpr int ROWS = CT_N1 * FB;     // (k1, frame) rows of a group
constexpr int CT_NT = 256;           // threads of the factored kernel
constexpr int ZP = CT_N2 + 8;        // bf16 row pitch (272 B): conflict-free
constexpr int ST_T = 1, ST_A = 2, ST_W = 4, ST_C = 8;

// ------------------------------------------------------------------ X1

// Frames x (M, 2048) float32 @ w^T, w (npad, 2048) bf16 with row 2k =
// CF[:, k] and row 2k+1 = SF[:, k] -> Xr, Xi (M, 1025).
__global__ void __launch_bounds__(K3_NT)
ct_full_mma(const float* __restrict__ x, const bf16* __restrict__ w,
            float* __restrict__ xr, float* __restrict__ xi, int M) {
  __shared__ Tiles sm;
  const int n0 = blockIdx.x * K3_BN, m0 = blockIdx.y * K3_BM;
  auto fetch = [&](int i, int k) -> float2 {
    const int m = m0 + 16 * i + (threadIdx.x >> 4);
    return m < M ? *reinterpret_cast<const float2*>(x + (size_t)m * NFFT + k)
                 : make_float2(0.f, 0.f);
  };
  float acc[4][4][4];
  const bf16* wt = w + (size_t)n0 * NFFT;
  gemm_block<false>(fetch, wt, wt, NFFT, NFFT, sm, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int k = (n0 + wn + nt * 8 + t2) >> 1;
    if (k >= NBIN) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + g + 8 * h;
        if (m < M) {
          xr[(size_t)m * NBIN + k] = acc[mt][nt][2 * h];
          xi[(size_t)m * NBIN + k] = acc[mt][nt][2 * h + 1];
        }
      }
  }
}

constexpr int SG_M = 128, SG_N = 128, SG_K = 8, SG_PROMOTE = 64;

// Frames x (M, 2048) @ w, w (2048, npad) float32 with column 2k = CF[:, k]
// and column 2k+1 = SF[:, k] -> Xr, Xi (M, 1025). Thread (ty, tx) of 16 x 16
// holds rows ty*4 + [0, 4) and 64 + ty*4 + [0, 4), columns likewise, so its
// shared-memory reads are conflict-free float4s. The next 8-deep slice is
// loaded into registers during the current slice's products. Each 64 deep
// products are summed apart and then added to acc: one 2048-deep running
// sum in a register loses ~6x more to rounding (at F = 840 the grid is 119
// blocks, under one an SM, so the 64 registers this costs take no
// occupancy).
__global__ void __launch_bounds__(256)
ct_full_sgemm(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ xr, float* __restrict__ xi, int M,
              int npad) {
  __shared__ __align__(16) float As[SG_K][SG_M + 4];  // k-major
  __shared__ __align__(16) float Bs[SG_K][SG_N];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * SG_M, n0 = blockIdx.x * SG_N;
  const int ar = tid >> 1, ak = (tid & 1) * 4;  // A: one row, 4 k
  const int bk = tid >> 5, bn = (tid & 31) * 4;  // B: one k, 4 columns
  const bool a_ok = m0 + ar < M;
  const float* ap = x + (size_t)(m0 + ar) * NFFT + ak;
  const float* bp = w + (size_t)bk * npad + n0 + bn;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra = a_ok ? *reinterpret_cast<const float4*>(ap) : zero;
  float4 rb = *reinterpret_cast<const float4*>(bp);
  float acc[8][8], part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int k0 = 0; k0 < NFFT; k0 += SG_K) {
    As[ak][ar] = ra.x;
    As[ak + 1][ar] = ra.y;
    As[ak + 2][ar] = ra.z;
    As[ak + 3][ar] = ra.w;
    *reinterpret_cast<float4*>(&Bs[bk][bn]) = rb;
    __syncthreads();
    if (k0 + SG_K < NFFT) {
      ra = a_ok ? *reinterpret_cast<const float4*>(ap + k0 + SG_K) : zero;
      rb = *reinterpret_cast<const float4*>(bp + (size_t)(k0 + SG_K) * npad);
    }
#pragma unroll
    for (int k = 0; k < SG_K; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(&a[0]) =
          *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      *reinterpret_cast<float4*>(&a[4]) =
          *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      *reinterpret_cast<float4*>(&b[0]) =
          *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      *reinterpret_cast<float4*>(&b[4]) =
          *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    if ((k0 + SG_K) % SG_PROMOTE == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int k = (n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4)) >> 1;
      if (k < NBIN) {
        xr[(size_t)m * NBIN + k] = acc[i][j];
        xi[(size_t)m * NBIN + k] = acc[i][j + 1];
      }
    }
  }
}

// --------------------------------------------------------------- X2-X4

// Shared memory of the factored kernel: the 16-point constants, and with
// stage C the 128-point constants and a group's z. C128 and S128 are
// symmetric, so their rows serve as the n-major B operand as they are.
struct Small {
  float c16[CT_N1][CT_N1], s16[CT_N1][CT_N1];
};
template <bool BF16>
struct GemmSmem;
template <>
struct GemmSmem<true> {
  bf16 c[CT_N2][ZP], s[CT_N2][ZP];
  bf16 zr[ROWS][ZP], zi[ROWS][ZP];
};
template <>
struct GemmSmem<false> {
  float c[CT_N2][CT_N2], s[CT_N2][CT_N2];
  float zr[ROWS][CT_N2], zi[ROWS][CT_N2];
};
template <bool BF16>
struct FactSmem {
  Small small;
  GemmSmem<BF16> g;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// Stage C on the tensor cores: rows r = k1*FB + fb of the group at frame
// f0; warp w holds rows (w/4)*32 + [0, 32) and k2 columns (w%4)*32 +
// [0, 32) of both Xr and Xi. Three accumulators: zr@C and zi@S apart (Xr is
// their difference, as the script forms it), zr@S + zi@C. Eight 16-deep
// steps: short enough for the tensor cores' float32 sums.
__device__ __forceinline__ void stage_c(GemmSmem<true>& g,
                                        float* __restrict__ yr,
                                        float* __restrict__ yi, int F, int Fc,
                                        int f0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int gq = lane >> 2, t2 = (lane & 3) * 2;
  float p1[2][4][4], p2[2][4][4], pi[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) p1[mt][nt][q] = p2[mt][nt][q] = pi[mt][nt][q] = 0.f;
#pragma unroll
  for (int ks = 0; ks < CT_N2; ks += 16) {
    uint32_t bc[4][2], bs[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      frag_b(bc[nt], g.c, wn + nt * 8 + gq, ks + t2);
      frag_b(bs[nt], g.s, wn + nt * 8 + gq, ks + t2);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t ar[4], ai[4];
      frag_a(ar, g.zr, wm + mt * 16 + gq, ks + t2);
      frag_a(ai, g.zi, wm + mt * 16 + gq, ks + t2);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_bf16(p1[mt][nt], ar, bc[nt]);
        mma_bf16(p2[mt][nt], ai, bs[nt]);
        mma_bf16(pi[mt][nt], ar, bs[nt]);
        mma_bf16(pi[mt][nt], ai, bc[nt]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + mt * 16 + gq + 8 * h;
      const int k1 = r / FB, f = f0 + r % FB;
      if (f >= Fc) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const size_t o = ((size_t)k1 * F + f) * CT_N2 + wn + nt * 8 + t2;
        *reinterpret_cast<float2*>(yr + o) =
            make_float2(p1[mt][nt][2 * h] - p2[mt][nt][2 * h],
                        p1[mt][nt][2 * h + 1] - p2[mt][nt][2 * h + 1]);
        *reinterpret_cast<float2*>(yi + o) =
            make_float2(pi[mt][nt][2 * h], pi[mt][nt][2 * h + 1]);
      }
    }
}

// Stage C in float32 FFMA: warp w holds rows w*8 + [0, 8), lane l the k2
// columns 4l + [0, 4) of both Xr and Xi; z is read as a broadcast, C and S
// as conflict-free float4s.
__device__ __forceinline__ void stage_c(GemmSmem<false>& g,
                                        float* __restrict__ yr,
                                        float* __restrict__ yi, int F, int Fc,
                                        int f0) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 8;
  const int c0 = lane * 4;
  float p1[8][4], p2[8][4], pi[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) p1[r][j] = p2[r][j] = pi[r][j] = 0.f;
#pragma unroll 4
  for (int n = 0; n < CT_N2; ++n) {
    const float4 c4 = *reinterpret_cast<const float4*>(&g.c[n][c0]);
    const float4 s4 = *reinterpret_cast<const float4*>(&g.s[n][c0]);
    const float c[4] = {c4.x, c4.y, c4.z, c4.w};
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float zr = g.zr[r0 + r][n], zi = g.zi[r0 + r][n];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p1[r][j] = fmaf(zr, c[j], p1[r][j]);
        p2[r][j] = fmaf(zi, s[j], p2[r][j]);
        pi[r][j] = fmaf(zi, c[j], fmaf(zr, s[j], pi[r][j]));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = r0 + r, k1 = row / FB, f = f0 + row % FB;
    if (f >= Fc) continue;
    const size_t o = ((size_t)k1 * F + f) * CT_N2 + c0;
    *reinterpret_cast<float4*>(yr + o) =
        make_float4(p1[r][0] - p2[r][0], p1[r][1] - p2[r][1],
                    p1[r][2] - p2[r][2], p1[r][3] - p2[r][3]);
    *reinterpret_cast<float4*>(yi + o) =
        make_float4(pi[r][0], pi[r][1], pi[r][2], pi[r][3]);
  }
}

// The factored DFT of frames [0, Fc) of x into rows [0, Fc) of yr, yi (16,
// F, 128). tf: the tile's frames, read only without T. Constants: c16,
// s16 (16, 16) and c128, s128 (128, 128) in the mode's type (bf16 or
// float32), tc, ts (16, 128) float32.
template <bool BF16, int ST>
__global__ void __launch_bounds__(CT_NT)
ct_fact(const float* __restrict__ x, const void* c16p, const void* s16p,
        const float* __restrict__ tc, const float* __restrict__ ts,
        const void* c128p, const void* s128p, float* __restrict__ yr,
        float* __restrict__ yi, int F, int Fc, int tf) {
  constexpr bool T = ST & ST_T, A = ST & ST_A, W = ST & ST_W, C = ST & ST_C;
  typedef typename std::conditional<BF16, bf16, float>::type CT;
  extern __shared__ __align__(16) unsigned char raw[];
  Small& sm = *reinterpret_cast<Small*>(raw);
  GemmSmem<BF16>& g = reinterpret_cast<FactSmem<BF16>*>(raw)->g;
  const int tid = threadIdx.x;

  if constexpr (A) {
    const CT* c16 = static_cast<const CT*>(c16p);
    const CT* s16 = static_cast<const CT*>(s16p);
    for (int i = tid; i < CT_N1 * CT_N1; i += CT_NT) {
      sm.c16[i / CT_N1][i % CT_N1] = to_f(c16[i]);
      sm.s16[i / CT_N1][i % CT_N1] = to_f(s16[i]);
    }
  }
  if constexpr (C) {
    // 16-byte chunks of the 128 x 128 constants into padded rows
    constexpr int PER = 16 / sizeof(CT), CHUNKS = CT_N2 * CT_N2 / PER;
    const uint4* c128 = static_cast<const uint4*>(c128p);
    const uint4* s128 = static_cast<const uint4*>(s128p);
    for (int i = tid; i < CHUNKS; i += CT_NT) {
      const int r = i / (CT_N2 / PER), k = (i % (CT_N2 / PER)) * PER;
      *reinterpret_cast<uint4*>(&g.c[r][k]) = c128[i];
      *reinterpret_cast<uint4*>(&g.s[r][k]) = s128[i];
    }
  }
  __syncthreads();

  const int n2 = tid & (CT_N2 - 1);
  const int groups = (Fc + FB - 1) / FB;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int f0 = grp * FB;
#pragma unroll
    for (int rep = 0; rep < FB * CT_N2 / CT_NT; ++rep) {
      const int fb = (tid >> 7) + rep * (CT_NT / CT_N2), f = f0 + fb;
      float xv[CT_N1];
      if (f < Fc) {
        // T: x[f, n1*128 + n2]; without T, the tile's (tf, 2048) memory
        // read as (16, tf, 128): row n1*tf + fl of 128
        const float* src;
        int stride;
        if constexpr (T) {
          src = x + (size_t)f * NFFT + n2;
          stride = CT_N2;
        } else {
          const int t = f / tf, fl = f - t * tf;
          src = x + (size_t)t * tf * NFFT + (size_t)fl * CT_N2 + n2;
          stride = tf * CT_N2;
        }
#pragma unroll
        for (int n1 = 0; n1 < CT_N1; ++n1) xv[n1] = src[(size_t)n1 * stride];
      } else {
#pragma unroll
        for (int n1 = 0; n1 < CT_N1; ++n1) xv[n1] = 0.f;
      }
#pragma unroll 4
      for (int k1 = 0; k1 < CT_N1; ++k1) {
        float gr, gi;
        if constexpr (A) {
          // trap: the script's stage A is float32 even in bf16 mode (its
          // _dot rounds only the constant): float32 x, bf16-rounded C16
          gr = gi = 0.f;
#pragma unroll
          for (int n1 = 0; n1 < CT_N1; ++n1) {
            gr = fmaf(sm.c16[k1][n1], xv[n1], gr);
            gi = fmaf(sm.s16[k1][n1], xv[n1], gi);
          }
        } else {
          gr = gi = xv[k1];
        }
        float zr = gr, zi = gi;
        if constexpr (W) {
          const float c = __ldg(tc + k1 * CT_N2 + n2);
          const float s = __ldg(ts + k1 * CT_N2 + n2);
          zr = gr * c - gi * s;
          zi = gr * s + gi * c;
        }
        if constexpr (C) {
          // stage C's operand: rounded to bf16 in bf16 mode
          const int r = k1 * FB + fb;
          if constexpr (BF16) {
            g.zr[r][n2] = __float2bfloat16_rn(zr);
            g.zi[r][n2] = __float2bfloat16_rn(zi);
          } else {
            g.zr[r][n2] = zr;
            g.zi[r][n2] = zi;
          }
        } else if (f < Fc) {  // without C: z itself, float32, unrounded
          const size_t o = ((size_t)k1 * F + f) * CT_N2 + n2;
          yr[o] = zr;
          yi[o] = zi;
        }
      }
    }
    if constexpr (C) {
      __syncthreads();
      stage_c(g, yr, yi, F, Fc, f0);
      __syncthreads();
    }
  }
}

// Launch one instantiation: dynamic shared memory set once, and a grid of
// at most as many blocks as fit on the card at once (each walks over
// groups, loading its constants once).
template <bool BF16, int ST>
int launch_fact(const float* x, const void* c16, const void* s16,
                const float* tc, const float* ts, const void* c128,
                const void* s128, float* yr, float* yi, int F, int Fc, int tf,
                cudaStream_t st) {
  constexpr size_t smem =
      (ST & ST_C) ? sizeof(FactSmem<BF16>) : sizeof(Small);
  static int max_blocks = 0;
  if (max_blocks == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        ct_fact<BF16, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, ct_fact<BF16, ST>, CT_NT, smem)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    max_blocks = sms * per_sm;
  }
  const int groups = (Fc + FB - 1) / FB;
  const int grid = groups < max_blocks ? groups : max_blocks;
  ct_fact<BF16, ST><<<grid, CT_NT, smem, st>>>(x, c16, s16, tc, ts, c128,
                                               s128, yr, yi, F, Fc, tf);
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_fact_stages(int stages, const float* x, const void* c16,
                       const void* s16, const float* tc, const float* ts,
                       const void* c128, const void* s128, float* yr,
                       float* yi, int F, int Fc, int tf, cudaStream_t st) {
#define CT_CASE(S)                                                         \
  case S:                                                                  \
    return launch_fact<BF16, S>(x, c16, s16, tc, ts, c128, s128, yr, yi, F, \
                                Fc, tf, st);
  switch (stages) {
    CT_CASE(0) CT_CASE(1) CT_CASE(2) CT_CASE(3) CT_CASE(4) CT_CASE(5)
    CT_CASE(6) CT_CASE(7) CT_CASE(8) CT_CASE(9) CT_CASE(10) CT_CASE(11)
    CT_CASE(12) CT_CASE(13) CT_CASE(14) CT_CASE(15)
  }
#undef CT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// X1: frames x (F, 2048) float32 -> Xr, Xi (F, 1025). w: bf16 (npad,
// 2048) with rows 2k, 2k+1 = CF[:, k], SF[:, k]; or float32 (2048, npad)
// with those columns; npad = 2*1025 rounded up to 128, zero-padded.
extern "C" int dctts_ct_full(const float* x, const void* w, float* xr,
                             float* xi, int F, int bf16_mode, void* stream) {
  constexpr int npad = (2 * NBIN + K3_BN - 1) / K3_BN * K3_BN;
  if (F < 1 || (long long)F * NFFT >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16_mode)
    ct_full_mma<<<dim3(npad / K3_BN, (F + K3_BM - 1) / K3_BM), K3_NT, 0,
                  st>>>(x, static_cast<const bf16*>(w), xr, xi, F);
  else
    ct_full_sgemm<<<dim3(npad / SG_N, (F + SG_M - 1) / SG_M), 256, 0, st>>>(
        x, static_cast<const float*>(w), xr, xi, F, npad);
  return (int)cudaGetLastError();
}

// X2, X3, X4: frames x (F, 2048) float32 -> rows [0, Fc) of Xr, Xi (16, F,
// 128) (the caller zeroes the rest). stages: bits T 1, A 2, W 4, C 8; tf
// divides Fc. Constants as ct_fact says, contiguous.
extern "C" int dctts_ct_fact(const float* x, const void* c16, const void* s16,
                             const float* tc, const float* ts,
                             const void* c128, const void* s128, float* xr,
                             float* xi, int F, int Fc, int tf, int stages,
                             int bf16_mode, void* stream) {
  if (Fc < 1 || Fc > F || tf < 1 || Fc % tf || stages < 0 || stages > 15 ||
      (long long)F * NFFT >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_mode
             ? launch_fact_stages<true>(stages, x, c16, s16, tc, ts, c128,
                                        s128, xr, xi, F, Fc, tf, st)
             : launch_fact_stages<false>(stages, x, c16, s16, tc, ts, c128,
                                         s128, xr, xi, F, Fc, tf, st);
}
