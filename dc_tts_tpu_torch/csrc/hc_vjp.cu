// Kernel K4: the gated highway-conv (HC) block of training, forward and
// backward.
//
// Replaces dc_tts_tpu/ops/pallas_hc_vjp.py:hc_block_trainable (forward
// _fwd_kernel, backward _bwd_kernel). The design note is in
// dc_tts_tpu_torch/ops/hc_vjp.py. Per batch row, with K taps at dilation
// `rate` and `left` frames of zero padding in front:
//   h = sum_k x[t + k*rate - left] @ W[k] + b           (B*T, 2C)
//   y = g*h2 + (1-g)*x,  g = sigmoid(LN1(h[:, :C])),  h2 = LN2(h[:, C:])
// The backward recomputes h and produces dx, dW, db and the four layer-norm
// parameter gradients.
// Channels: the products copy 16 bytes at a time, so they take C % 4 == 0
// (float32) or C % 8 == 0 (bf16). A block of Cv channels, any Cv, is stored
// padded with zero channels to such a C (ops/hc_vjp.py); the row kernels
// take the layer norms over the Cv real channels and write 0 for y, dh and
// dx in the padding, so its zero rows of W and zero columns of dh add
// nothing to the real outputs of the products.
//
// Launches (all on the caller's stream; nothing here allocates):
//   tf32_parts_t   W^T per tap, (2C, K*C), as TF32 hi and lo parts
//   tc_gemm<FWD>   h = taps(x) @ W + b, the tap gather done by the loader
//   hc_fwd_rows    one block per row: both layer norms, the gate, y
// and backward
//   tf32_parts_t, tf32_parts   W^T as above, and W's parts in W's layout
//   tc_gemm<FWD>   h recomputed
//   hc_bwd_rows    a chunk of rows per block: dh, the residual part of dx,
//                  and per-chunk column partials of db, dgamma, dbeta
//   hc_col_sum     the partials summed over chunks in a fixed order
//   tc_gemm<DX>    dx += sum_k dh[t - k*rate + left] @ W[k]^T, a gather:
//                  each output row sums the K taps that read it (no atomics)
//   tf32_parts_t   dh^T, (2C, B*T padded to the k-tile), hi and lo
//   tc_gemm<DW>    dW = taps(x)^T @ dh over all B*T rows, split over row
//                  ranges into partials, then hc_col_sum in a fixed order
// With bf16 operands (bf16 mode, below) the TF32 copies are replaced by
// to_bf16 (W and x, once a call), hc_bwd_rows writes dh in bf16, and the
// products are wg::gemm<HcOp<FWD|DX|DW>> (csrc/bf16_wgmma.cuh).
// Every sum is taken in an order fixed by the shapes alone, so two calls on
// the same inputs give bitwise-equal results. No float atomics.
//
// Float32 products (tc_gemm): float32 on the tensor cores by a three-term
// TF32 split, the Hopper form of the TPU kernel's Precision.HIGHEST. Each
// operand value a = a_hi + a_lo, a_hi = tf32(a), a_lo = tf32(a - a_hi), both
// rounded to nearest (cvt.rna: the tensor cores would drop the low 13 bits
// of an unrounded value), and a*b = a_hi*b_hi + a_hi*b_lo + a_lo*b_hi with
// float32 sums (a_lo*b_lo, ~2^-22 relative, is dropped). Bound on the H100:
// 3 x 2*B*T*K*C*2C TF32 operations a product at 495 TFLOP/s, one product
// forward and three backward (h recomputed, dx, dW); 2.05 ms forward and
// 6.15 ms backward at SSRN's HC(3,1), C = 1024, B*T = 26880, against 5.05
// and 15.1 ms for the same float32 work on the FMA units (67 TFLOP/s).
// What the design does about what held the SIMT SGEMM it replaces at
// 22-31 % of the FMA bound:
//  1. Scalar tap gather. The loader copies 16 bytes a thread with cp.async:
//     an A row's source address is computed once a k-tile from a table of
//     (b*T, t) per row, and the tap (k, c) of the thread's column is
//     advanced, not divided. The conv's zero padding (rows outside [0, T)
//     of their own batch row, which a tile may cross) is zero fill
//     (src-size 0).
//  2. Exposed latency. A ring of STAGES shared-memory stages; one producer
//     warpgroup keeps up to STAGES k-tiles in flight, each stage's copies
//     arriving on its `full` mbarrier (cp.async.mbarrier.arrive.noinc), and
//     the two consumer warpgroups release a stage on its `empty` mbarrier
//     when their products have read it. setmaxnreg hands the producer's
//     registers to the consumers. No TMA: the shifted activation rows need
//     zero fill per row at batch-row edges inside a tile, which a tensor
//     map's box does not give, so one cp.async loader serves every operand
//     (TMA would serve only B, through cuTensorMapEncodeTiled).
//  3. FMA units. wgmma m64n128k8 .tf32, A (split in registers) from
//     registers, B's hi and lo K-major in shared memory (128-byte swizzle,
//     written by cp.async in that pattern): 12 wgmmas a 32-deep k-tile.
//     Block tile 128 x 128, each consumer warpgroup 64 x 128.
//  4. Shape. SSRN's HC(3,1) is 3,360 output tiles forward; a block holds
//     one SM (the ring is 200 KB), so the grid runs ~25 waves there.
// Layouts. tf32 wgmma takes B K-major only, so each product's B is a split
// copy made by the prep kernels, K-major: forward W^T per tap (2C, K*C);
// dx W[k, c, j] read as (c, (k, j)), K-major as it lies (split in place);
// dW dh^T (2C, B*T). A is read from shared memory into registers, so any
// staged layout serves: taps(x) rows for the forward, shifted dh rows for
// dx, and for dW x rows staged (q, m), q = (b, t), m = (k, c). dW splits dh
// and not x: dh^T's rows stay 16-byte aligned at any T, where an x^T of
// padded batch rows would put the shift k*rate inside a 16-byte copy.
// Accumulation. The tensor cores' float32 sums truncate over long depths
// (dW's is B*T), so every PROMOTE k-tiles the wgmma accumulators are added
// into separate float32 register sums and restart from zero.
// The layer norms, gate and their gradients are a few passes over (B*T, 2C)
// rows, bound by device memory. No fast math.
//
// bf16 mode (the TPU kernel's bf16 operand body, pallas_hc_vjp.py:_make_dot
// and _make_dotg, taken under compute_dtype="bfloat16"): the same three tap
// products with every operand rounded to bf16 (nearest even) and float32
// sums: h = bf16(taps) @ bf16(W), dx = bf16(dh) @ bf16(W)^T, dW = bf16(taps)^T
// @ bf16(dh). Bound: the same operations at the dense bf16 rate, 989 TFLOP/s
// (0.366 ms forward, 1.10 backward at SSRN's HC(3,1)). The products run on
// the pipelined bf16 wgmma core of csrc/bf16_wgmma.cuh (128 x 128 block
// tiles, 64-deep k-tiles, a 6-stage cp.async ring on mbarriers, promotion
// to float32 register sums every 2 k-tiles). What it does about what held
// the scalar-loader mma.sync GEMM it replaces at ~3 % of the bound:
//  1. Rounding is elementwise, so bf16(taps(x)) = taps(bf16(x)): x and W are
//     rounded once a call (to_bf16) and hc_bwd_rows writes dh in bf16, where
//     only the products read it. The loader then gathers bf16 with 16-byte
//     cp.async as the float32 core's does (the (b*T, t) row table, the tap
//     (k, c) advanced by 64 a k-tile, the conv's padding as zero fill), with
//     half the L2 bytes and no split in registers. The copies need C % 8 ==
//     0 (other widths are padded, see the top). The single producer warp of
//     each SM sub-partition paces the core (its address arithmetic is one
//     dependent chain a k-tile), so each thread computes its 8 A rows'
//     source offsets once a tap, not once a k-tile, and every other
//     operand's rows from one base a k-tile.
//  2. bf16 wgmma reads either operand from shared memory K-major or
//     MN-major, so nothing is transposed in device memory: forward A =
//     taps(x) rows K-major, B = W (K*C, 2C) MN-major as it lies; dx A =
//     shifted dh rows K-major, B = W[k] read as (c, (k, j)) K-major; dW A =
//     x rows staged (q, m) MN-major, B = dh (B*T, 2C) MN-major as it lies.
//  3. dW keeps its split over row ranges and hc_col_sum's fixed-order sum.
// The row kernels stay float32, and every sum keeps its fixed order.

#include <cuda_runtime.h>

#include "bf16_wgmma.cuh"
#include "sm90.cuh"

namespace {

constexpr int RT = 256;  // threads of the row kernels
constexpr int FWD = 0, DX = 1, DW = 2;

// ---------------------------------------------------------------------------
// The float32 products on the tensor cores (3xTF32; see the top)

constexpr int TBM = 128, TBN = 128;  // block tile
constexpr int TBK = 32;              // k-tile: 32 floats, one 128-byte row
constexpr int STAGES = 4;            // shared-memory ring
// k-tiles summed on the tensor cores between promotions to the float32
// register sums: fixed at 4, chosen on the card against K4's gate at SSRN's
// shape (without promotion dW fails it; PERF.md)
constexpr int PROMOTE = 4;
constexpr int TC_THREADS = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int A_PITCH = TBK + 4;     // FWD/DX A tile [m][k]: conflict-free
constexpr int AT_PITCH = TBM + 8;    // DW A tile [q][m]: conflict-free
constexpr int B_BYTES = TBN * TBK * 4;             // one of B's parts
constexpr int A_BYTES = TBM * A_PITCH * 4;         // >= TBK * AT_PITCH * 4
constexpr int STAGE_BYTES = 2 * B_BYTES + A_BYTES; // B hi | B lo | A
constexpr size_t TC_SMEM = 1024 + (size_t)STAGES * STAGE_BYTES +
                           2 * STAGES * sizeof(uint64_t) + TBM * sizeof(int2);
static_assert(STAGE_BYTES % 1024 == 0, "B tiles must stay 1024-aligned");
static_assert(TBK * AT_PITCH * 4 <= A_BYTES, "DW's A tile must fit");

// out (M, N) = A (M, Q) @ B (Q, N) over q in [z*q_split, (z+1)*q_split),
// z = blockIdx.z:  FWD: out = acc + bias;  DX: out += acc;
// DW: out[z] = acc (partials). A is read through the tap gather of MODE
// (load_a's indexing); B as its split parts Bhi, Blo:
//   FWD, DW: row n of ldb floats, q contiguous (W^T per tap; dh^T)
//   DX:      W[k, n, j] at q = (k, j), in W's own layout
struct TcArgs {
  const float* A;
  const float* Bhi;
  const float* Blo;
  float* out;
  const float* bias;
  int M, N, Q, q_split, ldb;
  int T, C, rate, left;
};

template <int MODE>
__global__ void __launch_bounds__(TC_THREADS, 1) tc_gemm(const TcArgs p) {
  extern __shared__ uint8_t smem_raw[];
  // the B tiles start on 1024-byte boundaries of the shared window
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = (uint64_t*)(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  int2* rows = (int2*)(empty + STAGES);  // FWD/DX: (b*T, t) of each A row
  const int tid = threadIdx.x;
  const int m0 = (int)blockIdx.y * TBM, n0 = (int)blockIdx.x * TBN;
  const int qb = (int)blockIdx.z * p.q_split;
  const int qe = min(p.Q, qb + p.q_split);
  const int nk = qe > qb ? (qe - qb + TBK - 1) / TBK : 0;
  const int T = p.T;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 128);  // one cp.async arrival a producer
      sm90::mbar_init(&empty[s], 256); // one arrival a consumer thread
    }
    sm90::mbar_fence_init();
  }
  if (MODE != DW)
    for (int r = tid; r < TBM; r += TC_THREADS) {
      const int m = m0 + r, b = m / T;
      rows[r] = m < p.M ? make_int2(b * T, m - b * T) : make_int2(-1, 0);
    }
  __syncthreads();

  if (tid >= 256) {
    // ---------------- producer warpgroup: cp.async into the ring
    sm90::regs_dec<56>();
    const int pt = tid - 256;
    const int col = pt & 7, row0 = pt >> 3;  // A (FWD/DX) and B: rows
                                             // row0 + 16i, 16-byte chunk col
    const int swz = (col ^ (row0 & 7)) * 16; // its place in a B row
    // FWD/DX: the tap (k, c) of this thread's chunk q = q0 + 4*col, c over
    // Cq = C (x) or 2C (dh)
    const int Cq = MODE == DX ? 2 * p.C : p.C;
    int k = 0, c = 0;
    if (MODE != DW) {
      const int q = qb + 4 * col;
      k = q / Cq;
      c = q - k * Cq;
    }
    // DW: this thread's A column m = m0 + 4*mc, q rows pt/32 + 4i
    const int mc = pt & 31;
    const int mw = m0 + 4 * mc, km = mw / p.C, cm = mw - km * p.C;
    const int shift_m = km * p.rate - p.left;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) sm90::mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
      uint8_t* st = smem + s * STAGE_BYTES;
      const uint32_t bhi = sm90::smem_u32(st), blo = bhi + B_BYTES;
      const uint32_t as = bhi + 2 * B_BYTES;
      const int q0 = qb + kt * TBK;
      const int q = q0 + 4 * col;
      const bool qok = q < qe;
      // B: 128 rows x 8 chunks, hi and lo
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = row0 + 16 * i, n = n0 + r;
        const bool ok = qok && n < p.N;
        size_t off = 0;
        if (ok)
          off = MODE == DX ? ((size_t)k * p.C + n) * Cq + c
                           : (size_t)n * p.ldb + q;
        const uint32_t d = r * 128 + swz;
        sm90::cp_async16(bhi + d, p.Bhi + off, ok ? 16 : 0);
        sm90::cp_async16(blo + d, p.Blo + off, ok ? 16 : 0);
      }
      if (MODE != DW) {
        // A: 128 rows x 8 chunks; row m reads row s of its own batch row
        const int shift = MODE == DX ? p.left - k * p.rate
                                     : k * p.rate - p.left;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = row0 + 16 * i;
          const int2 bt = rows[r];
          const int sr = bt.y + shift;
          const bool ok = qok && bt.x >= 0 && sr >= 0 && sr < T;
          const size_t off = ok ? (size_t)(bt.x + sr) * Cq + c : 0;
          sm90::cp_async16(as + (r * A_PITCH + 4 * col) * 4, p.A + off,
                           ok ? 16 : 0);
        }
        c += TBK;  // the next k-tile's tap
        while (c >= Cq) {
          c -= Cq;
          ++k;
        }
      } else {
        // A: 32 q rows x 32 chunks of m; x[b, t + k*rate - left, c]
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = (pt >> 5) + 4 * i, qr = q0 + r;
          const int b = qr / T, sr = qr - b * T + shift_m;
          const bool ok = qr < qe && mw < p.M && sr >= 0 && sr < T;
          const size_t off = ok ? ((size_t)b * T + sr) * p.C + cm : 0;
          sm90::cp_async16(as + (r * AT_PITCH + 4 * mc) * 4, p.A + off,
                           ok ? 16 : 0);
        }
      }
      sm90::cp_async_arrive(&full[s]);
    }
    sm90::cp_async_wait_all();
  } else {
    // ---------------- consumer warpgroups: 64 rows x 128 columns each
    sm90::regs_inc<224>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int ra = wg * 64 + warp * 16 + g;  // A rows ra, ra + 8 of the tile
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      sm90::mbar_wait(&full[s], (kt / STAGES) & 1);
      sm90::fence_proxy_async();
      const uint8_t* st = smem + s * STAGE_BYTES;
      const float* as = (const float*)(st + 2 * B_BYTES);
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = ra + 8 * (v & 1), kk = ks * 8 + t4 + 4 * (v >> 1);
          const float a = MODE == DW ? as[kk * AT_PITCH + r]
                                     : as[r * A_PITCH + kk];
          sm90::tf32_split(a, ahi[ks][v], alo[ks][v]);
        }
      const uint32_t bhi = sm90::smem_u32(st), blo = bhi + B_BYTES;
      const int keep = kt % PROMOTE != 0;  // 0: restart the tensor-core sum
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        sm90::wgmma_m64n128k8_tf32(acc, ahi[ks],
                                   sm90::desc_sw128(bhi + 32 * ks),
                                   ks == 0 ? keep : 1);
        sm90::wgmma_m64n128k8_tf32(acc, ahi[ks],
                                   sm90::desc_sw128(blo + 32 * ks), 1);
        sm90::wgmma_m64n128k8_tf32(acc, alo[ks],
                                   sm90::desc_sw128(bhi + 32 * ks), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::mbar_arrive(&empty[s]);
      if (kt % PROMOTE == PROMOTE - 1 || kt == nk - 1)
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
    float* o = MODE == DW ? p.out + (size_t)blockIdx.z * p.M * p.N : p.out;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + ra + 8 * h, n = n0 + 8 * i + 2 * t4;
        if (m >= p.M || n >= p.N) continue;  // N is even
        float2* at = reinterpret_cast<float2*>(o + (size_t)m * p.N + n);
        float2 v = make_float2(sum[4 * i + 2 * h], sum[4 * i + 2 * h + 1]);
        if (MODE == FWD) {
          v.x += p.bias[n];
          v.y += p.bias[n + 1];
        } else if (MODE == DX) {
          const float2 r = *at;
          v.x += r.x;
          v.y += r.y;
        }
        *at = v;
      }
  }
}

// hi, lo = the TF32 split of src's n floats, in src's layout
__global__ void tf32_parts(const float* __restrict__ src,
                           float* __restrict__ hi, float* __restrict__ lo,
                           size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    uint32_t h, l;
    sm90::tf32_split(src[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

// src (R, Cc) row-major -> hi, lo (Cc, ld): the TF32 split of src^T, zero in
// columns [R, ld). 32 x 32 tiles through shared memory; block (32, 8).
__global__ void tf32_parts_t(const float* __restrict__ src,
                             float* __restrict__ hi, float* __restrict__ lo,
                             int R, int Cc, int ld) {
  __shared__ float tile[32][33];
  const int c0 = (int)blockIdx.x * 32, r0 = (int)blockIdx.y * 32;
  const int tx = threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    tile[i][tx] = (r < R && c < Cc) ? src[(size_t)r * Cc + c] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    if (c >= Cc || r >= ld) continue;
    uint32_t h, l;
    sm90::tf32_split(tile[tx][i], h, l);
    hi[(size_t)c * ld + r] = __uint_as_float(h);
    lo[(size_t)c * ld + r] = __uint_as_float(l);
  }
}

// ---------------------------------------------------------------------------
// The bf16 products on the bf16 wgmma core (see the top)

// bf16(src) of n floats, rounded to nearest even
__global__ void to_bf16(const float* __restrict__ src, bf16* __restrict__ dst,
                        size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

// out (M, N) = A (M, Q) @ B (Q, N) over q in [z*q_split, (z+1)*q_split),
// z = blockIdx.z, from the bf16 copies:  FWD: out = acc + bias, A = taps of
// x (B*T, C), B = W (K*C, 2C);  DX: out += acc, A = taps of dh (B*T, 2C), B
// = W[k, n, j] at q = (k, j);  DW: out[z] = acc (partials), A[m, q] = x at
// the tap m = (k, c) of row q, B = dh (B*T, 2C).
struct HcArgs {
  const bf16* A;
  const bf16* B;
  float* out;
  const float* bias;
  int M, N, Q, q_split;
  int T, C, rate, left;
};

template <int MODE>
struct HcOp {
  typedef HcArgs Args;
  static constexpr int PARTS = 1;
  static constexpr bool A_MN = MODE == DW, B_MN = MODE != DX;
  struct Shared {
    int2 rows[wg::BM];  // FWD/DX: (b*T, t) of each A row
  };
  const Args p;
  int m0, n0, qb, qe, nk;
  bool skip = false;
  // producer state: FWD/DX the tap (k, c) of this thread's q chunk; DW its
  // m chunk's tap and the t of its 8 q rows
  int k = 0, c = 0, shift_m = 0, cm = 0;
  // FWD/DX: the tap whose rows rowoff holds, and the element offset of the
  // source row of each of this thread's 8 A rows at that tap (-1: padding)
  int kcur = -1;
  int rowoff[8];
  bool mok = false;
  int tq[8];

  __device__ HcOp(const Args& a) : p(a) {
    m0 = (int)blockIdx.y * wg::BM;
    n0 = (int)blockIdx.x * wg::BN;
    qb = (int)blockIdx.z * p.q_split;
    qe = min(p.Q, qb + p.q_split);
    nk = qe > qb ? (qe - qb + wg::BK - 1) / wg::BK : 0;
  }

  __device__ void zero_tile(int) {}

  __device__ void init_shared(Shared& sh, int tid) {
    if (MODE != DW)
      for (int r = tid; r < wg::BM; r += wg::THREADS) {
        const int m = m0 + r, b = m / p.T;
        sh.rows[r] = m < p.M ? make_int2(b * p.T, m - b * p.T)
                             : make_int2(-1, 0);
      }
  }

  __device__ void producer_init(const Shared&, int pt) {
    if (MODE != DW) {
      const int Cq = MODE == DX ? 2 * p.C : p.C;
      const int q = qb + 8 * (pt & 7);
      k = q / Cq;
      c = q - k * Cq;
    } else {
      const int m = m0 + 8 * (pt & 15);
      mok = m < p.M;
      const int km = m / p.C;
      cm = m - km * p.C;
      shift_m = km * p.rate - p.left;
#pragma unroll
      for (int i = 0; i < 8; ++i) tq[i] = (qb + (pt >> 4) + 8 * i) % p.T;
    }
  }

  // B rows q0 + r (r = pt/16 + 8i) of a (Q, N) matrix, MN-major
  __device__ void load_b_rows(uint32_t b, int pt, int q0) const {
    const int j = pt & 15, n = n0 + 8 * j, rr0 = pt >> 4;
    const size_t base = (size_t)(q0 + rr0) * p.N + n;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rr0 + 8 * i;
      const bool ok = q0 + r < qe && n < p.N;
      const size_t off = ok ? base + (size_t)(8 * i) * p.N : 0;
      sm90::cp_async16(b + wg::mnmaj(r, j), p.B + off, ok ? 16 : 0);
    }
  }

  __device__ void load(const Shared& sh, int kt, uint32_t a, uint32_t b) {
    const int pt = threadIdx.x - 256;
    const int q0 = qb + kt * wg::BK;
    if (MODE != DW) {
      // A: 128 rows x 8 chunks; row m reads row s of its own batch row
      const int col = pt & 7, row0 = pt >> 3;
      const int Cq = MODE == DX ? 2 * p.C : p.C;
      const bool qok = q0 + 8 * col < qe;
      if (k != kcur) {  // a new tap: its source rows
        const int shift = MODE == DX ? p.left - k * p.rate
                                     : k * p.rate - p.left;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int2 bt = sh.rows[row0 + 16 * i];
          const int sr = bt.y + shift;
          rowoff[i] = bt.x >= 0 && sr >= 0 && sr < p.T ? (bt.x + sr) * Cq
                                                       : -1;
        }
        kcur = k;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool ok = qok && rowoff[i] >= 0;
        const size_t off = ok ? (size_t)rowoff[i] + c : 0;
        sm90::cp_async16(a + wg::kmaj(row0 + 16 * i, col), p.A + off,
                         ok ? 16 : 0);
      }
      if (MODE == DX) {
        // B: W[k, n, j] for the same (k, j) chunk, n rows, K-major
        const size_t base = ((size_t)k * p.C + n0 + row0) * Cq + c;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = row0 + 16 * i;
          const bool ok = qok && n0 + r < p.N;
          const size_t off = ok ? base + (size_t)(16 * i) * Cq : 0;
          sm90::cp_async16(b + wg::kmaj(r, col), p.B + off, ok ? 16 : 0);
        }
      } else {
        load_b_rows(b, pt, q0);
      }
      c += wg::BK;  // the next k-tile's tap
      while (c >= Cq) {
        c -= Cq;
        ++k;
      }
    } else {
      // A: 64 q rows x 16 chunks of m; x[b, t + k*rate - left, c], i.e.
      // x row q + shift_m while t + shift_m stays inside the batch row
      const int j = pt & 15, rr0 = pt >> 4;
      const size_t base = (size_t)(q0 + rr0) * p.C + cm;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rr0 + 8 * i;
        const int sr = tq[i] + shift_m;
        const bool ok = mok && q0 + r < qe && sr >= 0 && sr < p.T;
        const size_t off =
            ok ? base + (ptrdiff_t)(8 * i + shift_m) * p.C : 0;
        sm90::cp_async16(a + wg::mnmaj(r, j), p.A + off, ok ? 16 : 0);
        tq[i] += wg::BK;  // the row 64 further on
        while (tq[i] >= p.T) tq[i] -= p.T;
      }
      load_b_rows(b, pt, q0);
    }
  }

  // every value the tile reads back (bias, or dx for DX) is loaded before
  // the first store: loads after a store to memory they might alias would
  // each wait their turn
  __device__ void epilogue(const float (&sum)[64], int r, int t) const {
    float* o = MODE == DW ? p.out + (size_t)blockIdx.z * p.M * p.N : p.out;
    float2 add[16][2];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r + 8 * h, n = n0 + 8 * i + 2 * t;
        const bool in = m < p.M && n < p.N;  // N is even
        add[i][h] = make_float2(0.f, 0.f);
        if (MODE == FWD && in)
          add[i][h] = make_float2(p.bias[n], p.bias[n + 1]);
        else if (MODE == DX && in)
          add[i][h] = *reinterpret_cast<const float2*>(o + (size_t)m * p.N
                                                       + n);
      }
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r + 8 * h, n = n0 + 8 * i + 2 * t;
        if (m >= p.M || n >= p.N) continue;
        *reinterpret_cast<float2*>(o + (size_t)m * p.N + n) =
            make_float2(sum[4 * i + 2 * h] + add[i][h].x,
                        sum[4 * i + 2 * h + 1] + add[i][h].y);
      }
  }
};

// Sum NV values over the block; every thread gets the sums. The order is
// fixed (butterfly within warps, then warps in index order).
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) red[i * 32 + warp] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[i * 32 + w];
    v[i] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float sigmoidf(float z) {
  return 1.f / (1.f + expf(-z));
}

// mean and 1/sqrt(var + eps) of both halves of one h row (C channels a
// half, the first Cv of them real)
__device__ __forceinline__ void row_stats(const float* __restrict__ hr, int C,
                                          int Cv, float eps, float* red,
                                          float& mu1, float& inv1, float& mu2,
                                          float& inv2) {
  float s[2] = {0.f, 0.f};
  for (int c = threadIdx.x; c < Cv; c += blockDim.x) {
    s[0] += hr[c];
    s[1] += hr[C + c];
  }
  block_sum<2>(s, red);
  mu1 = s[0] / Cv;
  mu2 = s[1] / Cv;
  float v[2] = {0.f, 0.f};
  for (int c = threadIdx.x; c < Cv; c += blockDim.x) {
    const float d1 = hr[c] - mu1, d2 = hr[C + c] - mu2;
    v[0] += d1 * d1;
    v[1] += d2 * d2;
  }
  block_sum<2>(v, red);
  inv1 = rsqrtf(v[0] / Cv + eps);
  inv2 = rsqrtf(v[1] / Cv + eps);
}

__global__ void __launch_bounds__(RT)
hc_fwd_rows(const float* __restrict__ h, const float* __restrict__ x,
            const float* __restrict__ g1, const float* __restrict__ be1,
            const float* __restrict__ g2, const float* __restrict__ be2,
            float* __restrict__ y, int C, int Cv, float eps) {
  __shared__ float red[2 * 32];
  const size_t row = blockIdx.x;
  const float* hr = h + row * 2 * C;
  float mu1, inv1, mu2, inv2;
  row_stats(hr, C, Cv, eps, red, mu1, inv1, mu2, inv2);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    if (c >= Cv) {  // a zero channel of the padding
      y[row * C + c] = 0.f;
      continue;
    }
    const float g = sigmoidf((hr[c] - mu1) * inv1 * g1[c] + be1[c]);
    const float h2 = (hr[C + c] - mu2) * inv2 * g2[c] + be2[c];
    y[row * C + c] = g * h2 + (1.f - g) * x[row * C + c];
  }
}

// Rows [chunk*R, chunk*R + R) of the backward's elementwise part. Shared
// memory: the chunk's column sums acc[6C] = db (2C) | dgamma1 | dbeta1 |
// dgamma2 | dbeta2, then one row's n1, n2, dn1, dn2 (C each). A thread owns
// the columns c = threadIdx.x + i*blockDim.x in every array, so only the
// row reductions synchronise. dh is written as DH: float, or bf16 (rounded
// to nearest even) where only the bf16 products read it; db sums the
// float32 values either way. Channels c >= Cv are zero padding: their dh,
// dx and sums are 0, so the products' padded rows and columns add nothing.
template <class DH>
__global__ void __launch_bounds__(RT)
hc_bwd_rows(const float* __restrict__ h, const float* __restrict__ x,
            const float* __restrict__ dy, const float* __restrict__ g1,
            const float* __restrict__ be1, const float* __restrict__ g2,
            const float* __restrict__ be2, DH* __restrict__ dh,
            float* __restrict__ dx, float* __restrict__ part, int M, int C,
            int Cv, float eps, int R) {
  extern __shared__ float sm[];
  float* acc = sm;
  float* n1s = sm + 6 * C;
  float* n2s = n1s + C;
  float* dn1s = n2s + C;
  float* dn2s = dn1s + C;
  float* red = dn2s + C;  // 4 * 32
  for (int j = threadIdx.x; j < C; j += blockDim.x)
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[a * C + j] = 0.f;

  const int r0 = (int)blockIdx.x * R, r_end = min(M, r0 + R);
  for (int r = r0; r < r_end; ++r) {
    const size_t row = r;
    const float* hr = h + row * 2 * C;
    float mu1, inv1, mu2, inv2;
    row_stats(hr, C, Cv, eps, red, mu1, inv1, mu2, inv2);
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      if (c >= Cv) {
        dx[row * C + c] = 0.f;
        continue;
      }
      const float n1 = (hr[c] - mu1) * inv1;
      const float n2 = (hr[C + c] - mu2) * inv2;
      const float g = sigmoidf(n1 * g1[c] + be1[c]);
      const float h2 = n2 * g2[c] + be2[c];
      const float dyv = dy[row * C + c];
      const float dg = dyv * (h2 - x[row * C + c]);
      const float dh2 = dyv * g;
      const float dz1 = dg * g * (1.f - g);
      acc[2 * C + c] += dz1 * n1;
      acc[3 * C + c] += dz1;
      acc[4 * C + c] += dh2 * n2;
      acc[5 * C + c] += dh2;
      const float dn1 = dz1 * g1[c], dn2 = dh2 * g2[c];
      s[0] += dn1;
      s[1] += dn1 * n1;
      s[2] += dn2;
      s[3] += dn2 * n2;
      n1s[c] = n1;
      n2s[c] = n2;
      dn1s[c] = dn1;
      dn2s[c] = dn2;
      dx[row * C + c] = dyv * (1.f - g);
    }
    block_sum<4>(s, red);
    const float m1 = s[0] / Cv, m1n = s[1] / Cv, m2 = s[2] / Cv,
                m2n = s[3] / Cv;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const bool real = c < Cv;
      const float da = real ? inv1 * (dn1s[c] - m1 - n1s[c] * m1n) : 0.f;
      const float db = real ? inv2 * (dn2s[c] - m2 - n2s[c] * m2n) : 0.f;
      dh[row * 2 * C + c] = (DH)da;
      dh[row * 2 * C + C + c] = (DH)db;
      acc[c] += da;
      acc[C + c] += db;
    }
  }
  float* p = part + (size_t)blockIdx.x * 6 * C;
  for (int j = threadIdx.x; j < C; j += blockDim.x)
#pragma unroll
    for (int a = 0; a < 6; ++a) p[a * C + j] = acc[a * C + j];
}

// out[j] = sum_p part[p*L + j], p in index order, with a compensated
// (Kahan) sum: the row kernel leaves ~500 partials per column, whose plain
// running sum would lose several bits more than torch's tree reduction
__global__ void hc_col_sum(const float* __restrict__ part, int n_parts,
                           size_t L, float* __restrict__ out) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L) return;
  float s = 0.f, comp = 0.f;
  for (int p = 0; p < n_parts; ++p) {
    const float v = part[(size_t)p * L + j] - comp;
    const float t = s + v;
    comp = (t - s) - v;
    s = t;
  }
  out[j] = s;
}

// the float32 product on the tensor cores: out = A @ B from B's split parts
template <int MODE>
cudaError_t gemm_tc(const TcArgs& a, int splits, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      tc_gemm<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TC_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + TBN - 1) / TBN, (a.M + TBM - 1) / TBM, splits);
  tc_gemm<MODE><<<grid, TC_THREADS, TC_SMEM, st>>>(a);
  return cudaGetLastError();
}

// the bf16 product on the bf16 wgmma core; row ranges of q_split a
// multiple of the k-tile (a range past Q writes a zero partial)
template <int MODE>
cudaError_t gemm_bf16(const bf16* A, const bf16* Bm, float* out,
                      const float* bias, int M, int N, int Q, int splits,
                      int T, int C, int rate, int left, cudaStream_t st) {
  int q_split = (Q + splits - 1) / splits;
  q_split = (q_split + wg::BK - 1) / wg::BK * wg::BK;
  const HcArgs a{A, Bm, out, bias, M, N, Q, q_split, T, C, rate, left};
  return wg::launch<HcOp<MODE>>(
      a, dim3((N + wg::BN - 1) / wg::BN, (M + wg::BM - 1) / wg::BM, splits),
      st);
}

// dst = bf16(src), n floats
cudaError_t round_bf16(const float* src, bf16* dst, size_t n,
                       cudaStream_t st) {
  const unsigned nb = (unsigned)(n < 4096 * 256 ? (n + 255) / 256 : 4096);
  to_bf16<<<nb, 256, 0, st>>>(src, dst, n);
  return cudaGetLastError();
}

// W (K*C, 2C) -> W^T's split parts (2C, K*C) at wt, wt + K*C*2C
cudaError_t split_wt(const float* w, float* wt, int KC, int C2,
                     cudaStream_t st) {
  const dim3 grid((C2 + 31) / 32, (KC + 31) / 32);
  tf32_parts_t<<<grid, dim3(32, 8), 0, st>>>(w, wt, wt + (size_t)KC * C2, KC,
                                             C2, KC);
  return cudaGetLastError();
}

// h = taps(x) @ W + b from W^T's split parts wt
cudaError_t fwd_tc(const float* x, const float* wt, const float* b, float* h,
                   int M, int T, int C, int K, int rate, int left,
                   cudaStream_t st) {
  const int KC = K * C;
  const TcArgs a{x, wt, wt + (size_t)KC * 2 * C, h, b, M, 2 * C, KC,
                 (KC + TBK - 1) / TBK * TBK, KC, T, C, rate, left};
  return gemm_tc<FWD>(a, 1, st);
}

bool bad_geometry(int Bn, int T, int C, int Cv, int K, int rate, int left) {
  return Bn < 1 || T < 1 || Cv < 1 || Cv > C || K < 1 || rate < 1 ||
         left < 0 || left > (K - 1) * rate ||
         (size_t)Bn * T * 2 * C >= (1u << 31);
}

// the float32 products' 16-byte copies need C % 4 == 0; dh^T's padded rows
// must stay addressable in int. The bf16 products' copies need C % 8 == 0.
// (ops/hc_vjp.py stores a block of other Cv channels padded to such a C.)
bool bad_tc_geometry(int Bn, int T, int C, bool bf16_ops) {
  if (bf16_ops) return C % 8 != 0;
  const size_t ldq = ((size_t)Bn * T + TBK - 1) / TBK * TBK;
  return C % 4 != 0 || ldq * 2 * C >= (1u << 31);
}

}  // namespace

// y = HC(x) over channels of C, the first Cv real and the rest zero padding
// (x, W, b and the layer-norm vectors zero there; see hc_bwd_rows); y is 0
// in the padding. h: (B*T, 2C) scratch. bf16_ops: the tap product's operands in
// bf16 on the bf16 core, wsplit then holding bf16(W) (K*C*2C) | bf16(x)
// (B*T*C); otherwise wsplit (2 * K*C*2C floats) holds W^T's TF32 parts for
// the float32 product.
extern "C" int dctts_hc_fwd(const float* x, const float* w, const float* b,
                            const float* g1, const float* be1,
                            const float* g2, const float* be2, float* h,
                            float* y, void* wsplit, int Bn, int T, int C,
                            int Cv, int K, int rate, int left, float eps,
                            int bf16_ops, void* stream) {
  if (bad_geometry(Bn, T, C, Cv, K, rate, left) ||
      bad_tc_geometry(Bn, T, C, bf16_ops != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = Bn * T;
  cudaError_t e;
  if (bf16_ops) {
    bf16* wb = static_cast<bf16*>(wsplit);
    bf16* xb = wb + (size_t)K * C * 2 * C;
    if ((e = round_bf16(w, wb, (size_t)K * C * 2 * C, st)) == cudaSuccess &&
        (e = round_bf16(x, xb, (size_t)M * C, st)) == cudaSuccess)
      e = gemm_bf16<FWD>(xb, wb, h, b, M, 2 * C, K * C, 1, T, C, rate, left,
                         st);
  } else {
    float* ws = static_cast<float*>(wsplit);
    if ((e = split_wt(w, ws, K * C, 2 * C, st)) == cudaSuccess)
      e = fwd_tc(x, ws, b, h, M, T, C, K, rate, left, st);
  }
  if (e != cudaSuccess) return (int)e;
  hc_fwd_rows<<<M, RT, 0, st>>>(h, x, g1, be1, g2, be2, y, C, Cv, eps);
  return (int)cudaGetLastError();
}

// Gradients of HC at (x, params) for the cotangent dy, over C channels
// of which the first Cv are real (as dctts_hc_fwd; dy zero in the padding,
// every gradient zero there). Scratch: h (B*T,
// 2C); row_part (ceil(B*T/R), 6C); dw_part (dw_splits, K*C*2C), unused
// when dw_splits == 1. dparams (6C) = db (2C) | dg1 | dbe1 | dg2 | dbe2.
// bf16_ops: the three tap products' operands in bf16 on the bf16 core:
// wsplit = bf16(W) (K*C*2C) | bf16(x) (B*T*C), dhsplit = bf16(dh) (B*T,
// 2C), dh unused. Otherwise the float32 products: dh (B*T, 2C) float32, and
// their TF32 parts: wsplit (4 * K*C*2C floats) = W^T hi | W^T lo | W hi | W
// lo, dhsplit (2 * 2C * ldq floats, ldq = B*T rounded up to 32) = dh^T hi |
// dh^T lo.
extern "C" int dctts_hc_bwd(const float* x, const float* w, const float* b,
                            const float* g1, const float* be1,
                            const float* g2, const float* be2,
                            const float* dy, float* h, float* dh, float* dx,
                            float* dw, float* dparams, float* row_part,
                            float* dw_part, void* wsplit, void* dhsplit,
                            int Bn, int T, int C, int Cv, int K, int rate,
                            int left, float eps, int R, int dw_splits,
                            int bf16_ops, void* stream) {
  const bool lo = bf16_ops != 0;
  if (bad_geometry(Bn, T, C, Cv, K, rate, left) || R < 1 || dw_splits < 1 ||
      bad_tc_geometry(Bn, T, C, lo))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = Bn * T, n_chunks = (M + R - 1) / R;
  const int KC = K * C, C2 = 2 * C;
  const size_t LW = (size_t)KC * C2;
  const size_t smem = sizeof(float) * (10 * (size_t)C + 4 * 32);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = lo ? cudaFuncSetAttribute(hc_bwd_rows<bf16>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)
           : cudaFuncSetAttribute(hc_bwd_rows<float>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bf16* wb = static_cast<bf16*>(wsplit);
  bf16* xb = wb + LW;
  bf16* dhb = static_cast<bf16*>(dhsplit);
  float* ws = static_cast<float*>(wsplit);
  if (lo) {
    if ((e = round_bf16(w, wb, LW, st)) == cudaSuccess &&
        (e = round_bf16(x, xb, (size_t)M * C, st)) == cudaSuccess)
      e = gemm_bf16<FWD>(xb, wb, h, b, M, C2, KC, 1, T, C, rate, left, st);
  } else {
    float* whi = ws + 2 * LW;
    if ((e = split_wt(w, ws, KC, C2, st)) != cudaSuccess) return (int)e;
    const unsigned nb =
        (unsigned)(LW < 4096 * 256 ? (LW + 255) / 256 : 4096);
    tf32_parts<<<nb, 256, 0, st>>>(w, whi, whi + LW, LW);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    e = fwd_tc(x, ws, b, h, M, T, C, K, rate, left, st);
  }
  if (e != cudaSuccess) return (int)e;
  if (lo)
    hc_bwd_rows<bf16><<<n_chunks, RT, smem, st>>>(
        h, x, dy, g1, be1, g2, be2, dhb, dx, row_part, M, C, Cv, eps, R);
  else
    hc_bwd_rows<float><<<n_chunks, RT, smem, st>>>(
        h, x, dy, g1, be1, g2, be2, dh, dx, row_part, M, C, Cv, eps, R);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t L6 = 6 * (size_t)C;
  hc_col_sum<<<(unsigned)((L6 + 255) / 256), 256, 0, st>>>(row_part,
                                                           n_chunks, L6,
                                                           dparams);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  float* dw_out = dw_splits == 1 ? dw : dw_part;
  if (lo) {
    if ((e = gemm_bf16<DX>(dhb, wb, dx, nullptr, M, C, K * C2, 1, T, C, rate,
                           left, st)) != cudaSuccess ||
        (e = gemm_bf16<DW>(xb, dhb, dw_out, nullptr, KC, C2, M, dw_splits, T,
                           C, rate, left, st)) != cudaSuccess)
      return (int)e;
  } else {
    const float* whi = ws + 2 * LW;
    float* dhs = static_cast<float*>(dhsplit);
    const TcArgs adx{dh, whi, whi + LW, dx, nullptr, M, C, K * C2,
                     (K * C2 + TBK - 1) / TBK * TBK, 0, T, C, rate, left};
    if ((e = gemm_tc<DX>(adx, 1, st)) != cudaSuccess) return (int)e;
    const int ldq = (M + TBK - 1) / TBK * TBK;
    const dim3 grid((C2 + 31) / 32, ldq / 32);
    tf32_parts_t<<<grid, dim3(32, 8), 0, st>>>(
        dh, dhs, dhs + (size_t)C2 * ldq, M, C2, ldq);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    int q_split = (M + dw_splits - 1) / dw_splits;
    q_split = (q_split + TBK - 1) / TBK * TBK;
    const TcArgs adw{x, dhs, dhs + (size_t)C2 * ldq, dw_out, nullptr,
                     KC, C2, M, q_split, ldq, T, C, rate, left};
    if ((e = gemm_tc<DW>(adw, dw_splits, st)) != cudaSuccess) return (int)e;
  }
  if (dw_splits > 1)
    hc_col_sum<<<(unsigned)((LW + 255) / 256), 256, 0, st>>>(dw_part,
                                                             dw_splits, LW,
                                                             dw);
  return (int)cudaGetLastError();
}
