// Kernels X1-X4: the forward-rDFT prototypes of scripts/ct_kernel_exp.py.
//
// Replaces scripts/ct_kernel_exp.py's full_fwd (X1, _full_kernel),
// fact_fwd_tiled (X2, _fact_tiled_kernel), fact_fwd (X3, _fact_kernel) and
// ablate_fwd (X4, _ablate_kernel). The design note is in
// dc_tts_tpu_torch/ops/ct_fwd.py. Frames x are (F, 2048) float32.
//
//   dctts_ct_full  X1: [Xr | Xi] = x @ [CF, SF], a GEMM M = F, K = 2048,
//                  N = 2*1025 with CF and SF interleaved as rows of B^T
//                  (2k, 2k+1), so a lane's accumulator pair is one bin.
//                  bf16: x rounded once a call (round_bf16), then the
//                  pipelined bf16 wgmma core of csrc/bf16_wgmma.cuh; float32:
//                  the three-term TF32 split on wgmma (ct_full_tf32).
//   dctts_ct_fact  X2, X3 and X4: the 16 x 128 factored DFT,
//                  n = 128*n1 + n2, k = k1 + 16*k2, output (16, F, 128):
//                    T  x[f, n1, n2] read as (n1, f, n2) (without T: the
//                       tile's memory reinterpreted, the script's reshape)
//                    A  g[k1] = sum_n1 (C16 + i S16)[k1, n1] x[n1]  (FFMA)
//                    W  z = g * (Tc + i Ts)[k1, n2]                 (FFMA)
//                    C  X[k1, f, :] = z[k1, f, :] @ (C128 + i S128), as
//                       [zr | zi] @ [[C, S], [-S, C]]: bf16 wgmma with z
//                       rounded to bf16, or the TF32 split on wgmma
//                  Warp-specialised and persistent (ct_fact): one thread
//                  copies frames into a shared ring by bulk copies on
//                  mbarriers; consumer warpgroups run stages T, A, W for
//                  groups of 4 frames (64 (frame, k1) rows) and stage C on
//                  the tensor cores, the constant's k2 = 0..64 columns
//                  resident; the butterfly of C128's and S128's symmetry in
//                  k2 gives the other 63. The stage bits are template
//                  arguments, so a stage that is off costs no instruction.
//
// What bounds them on the H100: X1 its operations (7.05 GFLOP at F = 840:
// 7.1 us bf16; float32 105 us on the FMA units, 42.7 us as three TF32
// passes); the factored form needs 2.24 MFLOP a frame, mostly stage C (3.7x
// fewer than X1), so in bf16 its bytes (x read once, all 2048 bins of Xr
// and Xi written once: 6.2 us at F = 840) and in float32 its operations (28
// us on the FMA units).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"  // wg::gemm, wg::launch
#include "sm90.cuh"

namespace {

constexpr int NFFT = 2048, NBIN = NFFT / 2 + 1;
constexpr int CT_N1 = 16, CT_N2 = 128;
constexpr int ST_T = 1, ST_A = 2, ST_W = 4, ST_C = 8;

// ------------------------------------------------------------------ X1

// x (n4 float4s) -> xb bf16, rounded to nearest even: X1's left operand,
// rounded once a call
__global__ void round_bf16(const float4* __restrict__ x, uint2* __restrict__ xb,
                           int n4) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    const float4 v = x[i];
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    xb[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                       *reinterpret_cast<const uint32_t*>(&b));
  }
}

// X1's output: sum column n = 2k + e of the (M, npad) product is bin k's
// real (e = 0) or imaginary (e = 1) part; rows m < M, bins k < 1025
__device__ __forceinline__ void store_bins(float* __restrict__ xr,
                                           float* __restrict__ xi, int M,
                                           int m, int n, float re, float im) {
  const int k = n >> 1;
  if (m < M && k < NBIN) {
    xr[(size_t)m * NBIN + k] = re;
    xi[(size_t)m * NBIN + k] = im;
  }
}

// bf16: [Xr | Xi] = bf16(x) @ CS^T on the pipelined bf16 wgmma core
// (csrc/bf16_wgmma.cuh): A the rounded frames xb (M, 2048), B^T the
// interleaved constant w (npad, 2048), both K-major; a 128 x 128 tile a
// block, 32 k-tiles of 64.
struct X1Args {
  const bf16* xb;
  const bf16* w;
  float* xr;
  float* xi;
  int M;
};

struct X1Op {
  typedef X1Args Args;
  static constexpr int PARTS = 1;
  static constexpr bool A_MN = false, B_MN = false;
  struct Shared {};
  const Args p;
  int m0, n0, nk;
  bool skip = false;

  __device__ X1Op(const Args& a) : p(a) {
    m0 = (int)blockIdx.y * wg::BM;
    n0 = (int)blockIdx.x * wg::BN;
    nk = NFFT / wg::BK;
  }
  __device__ void init_shared(Shared&, int) {}
  __device__ void producer_init(const Shared&, int) {}
  __device__ void zero_tile(int) const {}

  // 128 rows x 8 chunks of A and of B^T; A rows >= M are zero fill
  __device__ void load(const Shared&, int kt, uint32_t a, uint32_t b) const {
    const int pt = threadIdx.x - 256, col = pt & 7, row0 = pt >> 3;
    const int k = kt * wg::BK + 8 * col;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + 16 * i, m = m0 + r;
      const bool ok = m < p.M;
      sm90::cp_async16(a + wg::kmaj(r, col),
                       p.xb + (ok ? (size_t)m * NFFT + k : 0), ok ? 16 : 0);
      sm90::cp_async16(b + wg::kmaj(r, col), p.w + (size_t)(n0 + r) * NFFT + k,
                       16);
    }
  }

  __device__ void epilogue(const float (&sum)[64], int r, int t) const {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_bins(p.xr, p.xi, p.M, m0 + r + 8 * h, n0 + 8 * i + 2 * t,
                   sum[4 * i + 2 * h], sum[4 * i + 2 * h + 1]);
  }
};

// float32: [Xr | Xi] = x @ CS^T by the three-term TF32 split on wgmma
// m64n128k8 .tf32 (K4's float32 core, csrc/hc_vjp.cu tc_gemm, without its
// tap gather): x split hi/lo in registers, CS^T's hi and lo parts (split
// once by ops/ct_fwd.py:consts) K-major in shared memory in the 128-byte
// swizzle, x*w = xh*wh + xh*wl + xl*wh. A 4-stage cp.async ring on mbarriers
// filled by a producer warpgroup; two consumer warpgroups of 64 rows; the
// tensor cores' sums promoted to float32 register sums every TF_PROMOTE
// k-tiles (64 products, as the SIMT kernel this replaces promoted).
constexpr int TF_BK = 32;                      // k-tile: one 128-byte row
constexpr int TF_STAGES = 4;
constexpr int TF_PROMOTE = 2;
constexpr int TF_APITCH = TF_BK + 4;           // A tile [m][k]: conflict-free
constexpr int TF_BBYTES = 128 * TF_BK * 4;     // one of B's parts
constexpr int TF_STAGE = 2 * TF_BBYTES + 128 * TF_APITCH * 4;
constexpr size_t TF_SMEM =
    1024 + (size_t)TF_STAGES * TF_STAGE + 2 * TF_STAGES * sizeof(uint64_t);
static_assert(TF_STAGE % 1024 == 0, "B tiles must stay 1024-aligned");

__global__ void __launch_bounds__(384, 1)
ct_full_tf32(const float* __restrict__ x, const float* __restrict__ whi,
             const float* __restrict__ wlo, float* __restrict__ xr,
             float* __restrict__ xi, int M) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = (uint64_t*)(smem + TF_STAGES * TF_STAGE);
  uint64_t* empty = full + TF_STAGES;
  const int tid = threadIdx.x;
  const int m0 = (int)blockIdx.y * 128, n0 = (int)blockIdx.x * 128;
  constexpr int nk = NFFT / TF_BK;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < TF_STAGES; ++s) {
      sm90::mbar_init(&full[s], 128);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------- producer warpgroup: rows row0 + 16i, chunk col
    sm90::regs_dec<56>();
    const int pt = tid - 256, col = pt & 7, row0 = pt >> 3;
    const int swz = (col ^ (row0 & 7)) * 16;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % TF_STAGES;
      if (kt >= TF_STAGES)
        sm90::mbar_wait(&empty[s], ((kt / TF_STAGES) - 1) & 1);
      const uint32_t bh = sm90::smem_u32(smem + s * TF_STAGE);
      const uint32_t bl = bh + TF_BBYTES, as = bh + 2 * TF_BBYTES;
      const int k = kt * TF_BK + 4 * col;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = row0 + 16 * i, m = m0 + r;
        const size_t wo = (size_t)(n0 + r) * NFFT + k;
        sm90::cp_async16(bh + r * 128 + swz, whi + wo, 16);
        sm90::cp_async16(bl + r * 128 + swz, wlo + wo, 16);
        const bool ok = m < M;
        sm90::cp_async16(as + (r * TF_APITCH + 4 * col) * 4,
                         x + (ok ? (size_t)m * NFFT + k : 0), ok ? 16 : 0);
      }
      sm90::cp_async_arrive(&full[s]);
    }
    sm90::cp_async_wait_all();
  } else {
    // ---------------- consumer warpgroups: 64 rows x 128 columns each
    sm90::regs_inc<224>();
    const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int ra = wgi * 64 + warp * 16 + g;  // A rows ra, ra + 8
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % TF_STAGES;
      sm90::mbar_wait(&full[s], (kt / TF_STAGES) & 1);
      sm90::fence_proxy_async();
      const uint8_t* st = smem + s * TF_STAGE;
      const float* as = (const float*)(st + 2 * TF_BBYTES);
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = ra + 8 * (v & 1), kk = ks * 8 + t4 + 4 * (v >> 1);
          sm90::tf32_split(as[r * TF_APITCH + kk], ahi[ks][v], alo[ks][v]);
        }
      const uint32_t bh = sm90::smem_u32(st), bl = bh + TF_BBYTES;
      const int keep = kt % TF_PROMOTE != 0;  // 0: restart the sum
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        sm90::wgmma_m64n128k8_tf32(acc, ahi[ks],
                                   sm90::desc_sw128(bh + 32 * ks),
                                   ks == 0 ? keep : 1);
        sm90::wgmma_m64n128k8_tf32(acc, ahi[ks],
                                   sm90::desc_sw128(bl + 32 * ks), 1);
        sm90::wgmma_m64n128k8_tf32(acc, alo[ks],
                                   sm90::desc_sw128(bh + 32 * ks), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::mbar_arrive(&empty[s]);
      if (kt % TF_PROMOTE == TF_PROMOTE - 1)
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_bins(xr, xi, M, m0 + ra + 8 * h, n0 + 8 * i + 2 * t4,
                   sum[4 * i + 2 * h], sum[4 * i + 2 * h + 1]);
  }
}

// --------------------------------------------------------------- X2-X4

// wgmma with A from registers and B (N = 72, K-major, 128-byte swizzle)
// from shared memory, d (64 x 72, float32) += a @ b: bf16 m64n72k16 (a: 4
// registers of bf16 pairs, the mma.m16n8k16 A layout of each warp's 16
// rows) and tf32 m64n72k8 (a: 4 registers, (g, t), (g+8, t), (g, t+4),
// (g+8, t+4)); d[4i + 2h + e] at row g + 8h, column 8i + 2t + e.
#define WG_D72                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35}"
#define WG_D72_OUT(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])

__device__ __forceinline__ void wgmma_n72_bf16(float (&d)[36],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 " WG_D72
      ", {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : WG_D72_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

__device__ __forceinline__ void wgmma_n72_tf32(float (&d)[36],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 " WG_D72
      ", {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : WG_D72_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

__device__ __forceinline__ void fence36(float (&d)[36]) {
#pragma unroll
  for (int i = 0; i < 36; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// named barrier `id` over `n` threads (whole warps)
__device__ __forceinline__ void wg_sync_n(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The factored kernel's stage-C constants (ops/ct_fwd.py:fact_consts):
// columns k2 = 0..64 of C128 and S128 (72 rows, 65..71 zero), each a
// K-major B tile of 72 rows of 128 bytes in the 128-byte swizzle, k = n2
// in k-tiles of 64 (bf16) or 32 (float32, its TF32 hi and lo parts): the
// bytes of the shared-memory image, in the order C, S (float32: C hi, C lo,
// S hi, S lo), k-tiles ascending.
constexpr int KC_N = 72;                 // B rows: k2 0..64, padded to 8
constexpr int KC_TILE = KC_N * 128;      // bytes of one k-tile
template <bool BF16>
struct FactC {
  static constexpr int KT = BF16 ? 2 : 4;        // k-tiles a matrix part
  static constexpr int PARTS = BF16 ? 2 : 4;     // C, S (, hi / lo)
  static constexpr int BYTES = PARTS * KT * KC_TILE;
};

// The factored kernel: one launch over frames [0, Fc), persistent over
// groups of GF frames (with C, 4: 64 (frame, k1) rows; else 1),
// warp-specialised: one producer thread (the last warpgroup) copies each
// frame into a ring of RING shared-memory stages (one bulk copy, or 16 rows
// of 512 bytes without T), each consumer warpgroup owning RING / NCW
// stages; the NCW consumer warpgroups run stages T, A, W (float32 FFMA,
// one thread an n2 of the warpgroup's frames side by side) and, with C
// (two warpgroups, w taking the group's frames 2w, 2w + 1), stage C on the
// tensor cores for the group's 64 rows, warpgroup 0 forming Xr's products
// and 1 Xi's, staged in shared memory and written out as whole 512-byte
// rows.
template <bool BF16, int ST>
struct Fact {
  static constexpr bool C = ST & ST_C;
  static constexpr int GF = C ? 4 : 1;
  // consumer warpgroups: two with C (stage A's FFMA spread over both, one
  // forming Xr's products, the other Xi's), else one
  static constexpr int NCW = C ? 2 : 1;
  static constexpr int THREADS = (NCW + 1) * 128;
  static constexpr int RING = C ? (BF16 ? 8 : 2) : 8;
  // z (bf16 or float32 zr | zi), then the outputs Xr | Xi staged there
  // (bulk copies of the staged rows to device memory, tried in bf16, were
  // slower than the threads' 16-byte stores; PERF.md)
  static constexpr int ZBYTES = C ? 2 * 64 * CT_N2 * 4 : 0;
  static constexpr size_t CONST_OFF = 0;
  static constexpr size_t Z_OFF = C ? FactC<BF16>::BYTES : 0;
  static constexpr size_t RING_OFF = Z_OFF + ZBYTES;
  // C16, S16 as float32 in shared memory, where there is room (not in
  // float32 with C: its constants fill it; there they are read through L1)
  static constexpr bool SMALL = !(C && !BF16);
  static constexpr size_t SMALL_OFF = RING_OFF + (size_t)RING * NFFT * 4;
  static constexpr size_t BAR_OFF =
      SMALL_OFF + (SMALL ? 2 * CT_N1 * CT_N1 * 4 : 0);
  static constexpr size_t SMEM = 1024 + BAR_OFF + (2 * RING + 1) * 8;
};

// 16 constants of row k1 of a (16, 16) matrix in the mode's type, read
// through L1
template <bool BF16>
__device__ __forceinline__ void row16(const void* m, int k1, float (&o)[16]) {
  if constexpr (BF16) {
    const uint4* q = static_cast<const uint4*>(m) + 2 * k1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 u = __ldg(q + h);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[8 * h + 2 * j] = __uint_as_float(w[j] << 16);
        o[8 * h + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  } else {
    const float4* q = static_cast<const float4*>(m) + 4 * k1;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 v = __ldg(q + h);
      o[4 * h] = v.x; o[4 * h + 1] = v.y; o[4 * h + 2] = v.z;
      o[4 * h + 3] = v.w;
    }
  }
}

// Rows of 128 values in shared memory (z, and the staged outputs): row r
// (frame j of the group, k1: r = 16j + k1), its 4-byte word w stored at
// w ^ 4*(r % 8), so the wgmma fragments' loads and stores see few bank
// conflicts and 16-byte groups of words stay together. bf16 z: words of
// two n2.
__device__ __forceinline__ int zword(int r, int w) {
  return w ^ ((r & 7) << 2);
}

// stage C's products for one warpgroup: P += za @ M1, Q += zb @ M2, 64 rows
// x 72 columns each, over the 128 n2 of the group's z (k-steps of 16 bf16 or
// 8 TF32; float32 by the three-term split). m1, m2: the constants' shared
// addresses (float32: hi, then lo KT k-tiles on). Each k-step's A fragments
// are loaded while the previous step's products run.
template <bool BF16>
__device__ __forceinline__ void stage_c(const uint32_t* za, const uint32_t* zb,
                                        uint32_t m1, uint32_t m2,
                                        float (&P)[36], float (&Q)[36]) {
  constexpr int KT = FactC<BF16>::KT, KSTEPS = BF16 ? 8 : 16;
  constexpr int SPT = KSTEPS / KT;  // k-steps a k-tile
  constexpr int PITCH = BF16 ? 64 : 128;  // words a z row
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = ((threadIdx.x >> 5) & 3) * 16 + g;  // rows ra, ra + 8
  uint32_t a[2][2][4], b[2][2][4];  // [buffer][hi, lo][register]
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int u = ks & 1;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = ra + 8 * (v & 1);
      const int w = r * PITCH + zword(r, 8 * ks + t4 + 4 * (v >> 1));
      if constexpr (BF16) {
        a[u][0][v] = za[w];
        b[u][0][v] = zb[w];
      } else {
        sm90::tf32_split(__uint_as_float(za[w]), a[u][0][v], a[u][1][v]);
        sm90::tf32_split(__uint_as_float(zb[w]), b[u][0][v], b[u][1][v]);
      }
    }
    fence36(P);
    fence36(Q);
    sm90::wgmma_fence();
    const uint32_t off = (ks / SPT) * KC_TILE + (ks % SPT) * 32;
    if constexpr (BF16) {
      wgmma_n72_bf16(P, a[u][0], sm90::desc_sw128(m1 + off));
      wgmma_n72_bf16(Q, b[u][0], sm90::desc_sw128(m2 + off));
    } else {
      const uint32_t lo = KT * KC_TILE;
      wgmma_n72_tf32(P, a[u][0], sm90::desc_sw128(m1 + off));
      wgmma_n72_tf32(P, a[u][0], sm90::desc_sw128(m1 + lo + off));
      wgmma_n72_tf32(P, a[u][1], sm90::desc_sw128(m1 + off));
      wgmma_n72_tf32(Q, b[u][0], sm90::desc_sw128(m2 + off));
      wgmma_n72_tf32(Q, b[u][0], sm90::desc_sw128(m2 + lo + off));
      wgmma_n72_tf32(Q, b[u][1], sm90::desc_sw128(m2 + off));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // the previous step's group: its buffer free
  }
  sm90::wgmma_wait<0>();
  fence36(P);
  fence36(Q);
}

template <bool BF16, int ST>
__global__ void __launch_bounds__(Fact<BF16, ST>::THREADS, 1)
ct_fact(const float* __restrict__ x, const void* c16, const void* s16,
        const float* __restrict__ tc, const float* __restrict__ ts,
        const void* kc, float* __restrict__ yr, float* __restrict__ yi,
        int F, int Fc, int tf) {
  typedef Fact<BF16, ST> K;
  constexpr bool T = ST & ST_T, A = ST & ST_A, W = ST & ST_W, C = K::C;
  constexpr int RING = K::RING, GF = K::GF, NCW = K::NCW;
  constexpr int FPW = GF / NCW;    // frames a warpgroup takes of a group
  constexpr int RPW = RING / NCW;  // ring stages a warpgroup owns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  float* ring = reinterpret_cast<float*>(smem + K::RING_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K::BAR_OFF);
  uint64_t* empty = full + RING;
  uint64_t* cbar = empty + RING;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int nq = (Fc + GF - 1) / GF;  // groups of GF frames
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      sm90::mbar_init(&full[s], 1);     // the producer's arrival (+ bytes)
      sm90::mbar_init(&empty[s], 128);  // the consuming warpgroup
    }
    sm90::mbar_init(cbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == NCW) {
    // ---------------- producer: one thread issues every copy; with C its
    // warpgroup hands its registers to the consumers' products
    if constexpr (NCW == 2) sm90::regs_dec<40>();
    if (tid != NCW * 128) return;
    if constexpr (C) {
      sm90::mbar_expect_tx(cbar, FactC<BF16>::BYTES);
      for (int o = 0; o < FactC<BF16>::BYTES; o += KC_TILE)
        sm90::bulk_copy(sm90::smem_u32(smem + K::CONST_OFF + o),
                        static_cast<const uint8_t*>(kc) + o, KC_TILE, cbar);
    }
    // each consumer warpgroup has its own RPW stages and takes its frames
    // in order, so no wait on a stage is ever two phases ahead of it
    for (int q = blockIdx.x, it = 0; q < nq; q += gridDim.x, ++it)
      for (int jj = 0; jj < FPW; ++jj)
        for (int w = 0; w < NCW; ++w) {
          const int k = it * FPW + jj, s = w * RPW + k % RPW;
          const int f = q * GF + w * FPW + jj;
          if (k >= RPW) sm90::mbar_wait(&empty[s], ((k / RPW) - 1) & 1);
          const uint32_t dst = sm90::smem_u32(ring + (size_t)s * NFFT);
          if (f >= Fc) {
            sm90::mbar_arrive(&full[s]);
          } else if (T) {
            sm90::mbar_expect_tx(&full[s], NFFT * 4);
            sm90::bulk_copy(dst, x + (size_t)f * NFFT, NFFT * 4, &full[s]);
          } else {
            // without T the tile's (tf, 2048) memory read as (16, tf, 128):
            // row n1*tf + fl of 128
            const int t = f / tf, fl = f - t * tf;
            const float* src =
                x + (size_t)t * tf * NFFT + (size_t)fl * CT_N2;
            sm90::mbar_expect_tx(&full[s], NFFT * 4);
            for (int n1 = 0; n1 < CT_N1; ++n1)
              sm90::bulk_copy(dst + n1 * CT_N2 * 4,
                              src + (size_t)n1 * tf * CT_N2, CT_N2 * 4,
                              &full[s]);
          }
        }
    return;
  }

  // ---------------- consumer warpgroup wgi: stages T, A, W of its frames
  if constexpr (NCW == 2) sm90::regs_inc<232>();
  const int n2 = tid & 127, warp = (tid >> 5) & 3, lane = tid & 31;
  float* small = reinterpret_cast<float*>(smem + K::SMALL_OFF);
  if constexpr (A && K::SMALL) {
    // C16, S16 widened to float32 once a block: read as 16-byte broadcasts
    for (int i = tid; i < 2 * CT_N1 * CT_N1; i += NCW * 128) {
      const void* m = i < CT_N1 * CT_N1 ? c16 : s16;
      const int e = i % (CT_N1 * CT_N1);
      small[i] = BF16 ? __bfloat162float(static_cast<const bf16*>(m)[e])
                      : static_cast<const float*>(m)[e];
    }
    wg_sync_n(1, NCW * 128);
  }
  uint32_t* zr = reinterpret_cast<uint32_t*>(smem + K::Z_OFF);
  uint32_t* zi = zr + (BF16 ? 64 * CT_N2 / 2 : 64 * CT_N2);
  for (int q = blockIdx.x, it = 0; q < nq; q += gridDim.x, ++it) {
    // its frames j = FPW * wgi + jj, side by side: each constant it loads
    // serves them all
    float xv[FPW][CT_N1];
#pragma unroll
    for (int jj = 0; jj < FPW; ++jj) {
      const int j = FPW * wgi + jj, k = it * FPW + jj;
      const int s = wgi * RPW + k % RPW;
      sm90::mbar_wait(&full[s], (k / RPW) & 1);
#pragma unroll
      for (int n1 = 0; n1 < CT_N1; ++n1)
        xv[jj][n1] = q * GF + j < Fc
                         ? ring[(size_t)s * NFFT + n1 * CT_N2 + n2] : 0.f;
      sm90::mbar_arrive(&empty[s]);
    }
    // unrolled whole: xv is indexed by k1 (without A), and a rolled loop
    // would put it in local memory
#pragma unroll
    for (int k1 = 0; k1 < CT_N1; ++k1) {
      float cr[CT_N1], ci[CT_N1];
      if constexpr (A) {
        if constexpr (K::SMALL) {
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float4 c = reinterpret_cast<const float4*>(small)[4 * k1 + h];
            const float4 v = reinterpret_cast<const float4*>(
                small + CT_N1 * CT_N1)[4 * k1 + h];
            cr[4 * h] = c.x; cr[4 * h + 1] = c.y; cr[4 * h + 2] = c.z;
            cr[4 * h + 3] = c.w;
            ci[4 * h] = v.x; ci[4 * h + 1] = v.y; ci[4 * h + 2] = v.z;
            ci[4 * h + 3] = v.w;
          }
        } else {
          row16<BF16>(c16, k1, cr);
          row16<BF16>(s16, k1, ci);
        }
      }
      // the twiddles of (k1, n2), read through L1 for each group: held
      // across groups they would crowd stage C's accumulators
      const float twc = W ? __ldg(tc + k1 * CT_N2 + n2) : 0.f;
      const float tws = W ? __ldg(ts + k1 * CT_N2 + n2) : 0.f;
#pragma unroll
      for (int jj = 0; jj < FPW; ++jj) {
        const int j = FPW * wgi + jj, f = q * GF + j;
        float gr, gi;
        if constexpr (A) {
          // trap: the script's stage A is float32 even in bf16 mode (its
          // _dot rounds only the constant): float32 x, bf16-rounded C16
          gr = gi = 0.f;
#pragma unroll
          for (int n1 = 0; n1 < CT_N1; ++n1) {
            gr = fmaf(cr[n1], xv[jj][n1], gr);
            gi = fmaf(ci[n1], xv[jj][n1], gi);
          }
        } else {
          gr = gi = xv[jj][k1];
        }
        float vr = gr, vi = gi;
        if constexpr (W) {
          vr = gr * twc - gi * tws;
          vi = gr * tws + gi * twc;
        }
        if constexpr (C) {
          // stage C's operand: rounded to bf16 in bf16 mode
          const int r = CT_N1 * j + k1;
          if constexpr (BF16) {
            const int w = r * 64 + zword(r, n2 >> 1);
            reinterpret_cast<bf16*>(zr + w)[n2 & 1] = __float2bfloat16_rn(vr);
            reinterpret_cast<bf16*>(zi + w)[n2 & 1] = __float2bfloat16_rn(vi);
          } else {
            const int w = r * 128 + zword(r, n2);
            reinterpret_cast<float*>(zr)[w] = vr;
            reinterpret_cast<float*>(zi)[w] = vi;
          }
        } else if (f < Fc) {  // without C: z itself, float32, unrounded
          const size_t o = ((size_t)k1 * F + f) * CT_N2 + n2;
          yr[o] = vr;
          yi[o] = vi;
        }
      }
    }
    if constexpr (C) {
      // Stage C: Xr's products P = zr @ C', Q = zi @ S' (warpgroup 0) and
      // Xi's R = zr @ S', U = zi @ C' (warpgroup 1, in its P and Q) over k2
      // = 0..64 (C' = C128[:, :72], S' likewise, zero past 64); the
      // butterfly of C128[:, 128-k] = C128[:, k], S128[:, 128-k] =
      // -S128[:, k] gives Xr[k] = P - Q, Xr[128-k] = P + Q, Xi[k] = R + U,
      // Xi[128-k] = U - R.
      wg_sync_n(1, 256);  // the group's z is complete
      if (it == 0) sm90::mbar_wait(cbar, 0);
      const uint32_t kcs = sm90::smem_u32(smem + K::CONST_OFF);
      constexpr uint32_t SOFF = FactC<BF16>::PARTS / 2 * FactC<BF16>::KT *
                                KC_TILE;  // S' after C'
      float P[36], Q[36];
#pragma unroll
      for (int i = 0; i < 36; ++i) P[i] = Q[i] = 0.f;
      stage_c<BF16>(zr, zi, wgi ? kcs + SOFF : kcs, wgi ? kcs : kcs + SOFF,
                    P, Q);
      wg_sync_n(1, 256);  // both warpgroups done with z: stage outputs there
      // warpgroup 0 stages Xr's 64 rows in z's first half, 1 Xi's in the
      // second: row r of 128 at r*128, zword's order
      float* stg = reinterpret_cast<float*>(zr) + wgi * 64 * CT_N2;
      const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        float* row = stg + r * CT_N2;
#pragma unroll
        for (int i = 0; i < 9; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * i + 2 * t4 + e, v = 4 * i + 2 * h + e;
            const float lo = wgi ? P[v] + Q[v] : P[v] - Q[v];
            const float hi = wgi ? Q[v] - P[v] : P[v] + Q[v];
            if (c <= 64) row[zword(r, c)] = lo;
            if (c >= 1 && c <= 63) row[zword(r, CT_N2 - c)] = hi;
          }
      }
      wg_sync_n(2 + wgi, 128);
      // each warp writes 16 rows, a row's 512 bytes by the 32 lanes
      float* out = wgi ? yi : yr;
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int r = warp * 16 + i, f = q * GF + r / CT_N1;
        if (f >= Fc) continue;
        const float4 v = *reinterpret_cast<const float4*>(
            stg + r * CT_N2 + zword(r, 4 * lane));
        *reinterpret_cast<float4*>(
            out + ((size_t)(r % CT_N1) * F + f) * CT_N2 + 4 * lane) = v;
      }
      wg_sync_n(1, 256);  // the staged outputs read: the next group's z
    }
  }
}

// Launch one instantiation: dynamic shared memory set once, and a grid of
// at most as many blocks as fit on the card at once (each walks over
// groups).
template <bool BF16, int ST>
int launch_fact(const float* x, const void* c16, const void* s16,
                const float* tc, const float* ts, const void* kc, float* yr,
                float* yi, int F, int Fc, int tf, cudaStream_t st) {
  typedef Fact<BF16, ST> K;
  static int max_blocks = 0;
  if (max_blocks == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        ct_fact<BF16, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)K::SMEM);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, ct_fact<BF16, ST>, K::THREADS, K::SMEM)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    max_blocks = sms * per_sm;
  }
  const int groups = (Fc + K::GF - 1) / K::GF;
  const int grid = groups < max_blocks ? groups : max_blocks;
  ct_fact<BF16, ST><<<grid, K::THREADS, K::SMEM, st>>>(
      x, c16, s16, tc, ts, kc, yr, yi, F, Fc, tf);
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_fact_stages(int stages, const float* x, const void* c16,
                       const void* s16, const float* tc, const float* ts,
                       const void* kc, float* yr, float* yi, int F, int Fc,
                       int tf, cudaStream_t st) {
#define CT_CASE(S)                                                        \
  case S:                                                                 \
    return launch_fact<BF16, S>(x, c16, s16, tc, ts, kc, yr, yi, F, Fc, tf, \
                                st);
  switch (stages) {
    CT_CASE(0) CT_CASE(1) CT_CASE(2) CT_CASE(3) CT_CASE(4) CT_CASE(5)
    CT_CASE(6) CT_CASE(7) CT_CASE(8) CT_CASE(9) CT_CASE(10) CT_CASE(11)
    CT_CASE(12) CT_CASE(13) CT_CASE(14) CT_CASE(15)
  }
#undef CT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// X1: frames x (F, 2048) float32 -> Xr, Xi (F, 1025). w: bf16 (npad, 2048)
// with rows 2k, 2k+1 = CF[:, k], SF[:, k]; or float32 (2, npad, 2048), the
// TF32 hi and lo parts of those rows; npad = 2*1025 rounded up to 128,
// zero-padded. xb: bf16 (F, 2048) scratch (bf16 mode).
extern "C" int dctts_ct_full(const float* x, const void* w, float* xr,
                             float* xi, void* xb, int F, int bf16_mode,
                             void* stream) {
  constexpr int npad = (2 * NBIN + 127) / 128 * 128;
  if (F < 1 || (long long)F * NFFT >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(npad / 128, (F + 127) / 128);
  if (bf16_mode) {
    const int n4 = F * NFFT / 4;
    round_bf16<<<(n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024, 256, 0,
                 st>>>(static_cast<const float4*>((const void*)x),
                       static_cast<uint2*>(xb), n4);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)wg::launch<X1Op>(
        X1Args{static_cast<const bf16*>(xb), static_cast<const bf16*>(w), xr,
               xi, F},
        grid, st);
  }
  cudaError_t e = cudaFuncSetAttribute(
      ct_full_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TF_SMEM);
  if (e != cudaSuccess) return (int)e;
  const float* wf = static_cast<const float*>(w);
  ct_full_tf32<<<grid, 384, TF_SMEM, st>>>(x, wf, wf + (size_t)npad * NFFT,
                                           xr, xi, F);
  return (int)cudaGetLastError();
}

// X2, X3, X4: frames x (F, 2048) float32 -> rows [0, Fc) of Xr, Xi (16, F,
// 128) (the caller zeroes the rest). stages: bits T 1, A 2, W 4, C 8; tf
// divides Fc. Constants contiguous: c16, s16 (16, 16) in the mode's type,
// tc, ts (16, 128) float32, kc stage C's image (FactC; read with C only).
extern "C" int dctts_ct_fact(const float* x, const void* c16, const void* s16,
                             const float* tc, const float* ts, const void* kc,
                             float* xr, float* xi, int F, int Fc, int tf,
                             int stages, int bf16_mode, void* stream) {
  if (Fc < 1 || Fc > F || tf < 1 || Fc % tf || stages < 0 || stages > 15 ||
      (long long)F * NFFT >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_mode
             ? launch_fact_stages<true>(stages, x, c16, s16, tc, ts, kc, xr,
                                        xi, F, Fc, tf, st)
             : launch_fact_stages<false>(stages, x, c16, s16, tc, ts, kc, xr,
                                         xi, F, Fc, tf, st);
}
