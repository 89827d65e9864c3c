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
//
// Launches (all on the caller's stream; nothing here allocates):
//   hc_gemm<FWD>   h = taps(x) @ W + b, the tap gather done in the tile load
//   hc_fwd_rows    one block per row: both layer norms, the gate, y
//   hc_bwd_rows    a chunk of rows per block: dh, the residual part of dx,
//                  and per-chunk column partials of db, dgamma, dbeta
//   hc_col_sum     the partials summed over chunks in a fixed order
//   hc_gemm<DX>    dx += sum_k dh[t - k*rate + left] @ W[k]^T, a gather:
//                  each output row sums the K taps that read it (no atomics)
//   hc_gemm<DW>    dW = taps(x)^T @ dh over all B*T rows, split over row
//                  ranges into partials, then hc_col_sum in a fixed order
// Every sum is taken in an order fixed by the shapes alone, so two calls on
// the same inputs give bitwise-equal results. No float atomics.
//
// Bound on the H100: the three tap matmuls (forward; backward recompute, dx
// and dW), 2*B*T*K*C*2C operations each, on the float32 FMA units (the
// tensor cores would round to TF32). The GEMM is a classic shared-memory
// SGEMM: 128x128 output tiles, 8-deep slices, 8x8 outputs per thread.
// The layer norms, gate and their gradients are a few passes over (B*T, 2C)
// rows, bound by device memory. No fast math.
//
// bf16 mode (the TPU kernel's bf16 operand body, pallas_hc_vjp.py:_make_dot
// and _make_dotg, taken under compute_dtype="bfloat16"): the same three tap
// products with every operand rounded to bf16 (nearest even) and products
// on the tensor cores (mma.sync m16n8k16 bf16 -> float32), sums in float32:
// h = bf16(taps) @ bf16(W), dx = bf16(dh) @ bf16(W)^T, dW = bf16(taps)^T @
// bf16(dh). Bound: the same operations at the dense bf16 rate. hc_gemm_bf16
// keeps hc_gemm's tiles, loaders and split, so the tap gather stays in the
// loader: each thread fetches float32 elements through load_a / load_b,
// rounds them and stores them to shared memory with k contiguous (the
// fragment layout of csrc/bf16_gemm.cuh), the next k-tile's fetch in flight
// during the products. Each 32-deep k-tile's products are summed on the
// tensor cores from zero and then added to float32 register sums: a long
// tensor-core accumulation truncates (Q reaches 3072, dW's depth B*T). The
// row kernels stay float32, and every sum keeps its fixed order.

#include <cuda_runtime.h>

#include "bf16_gemm.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8, GT = 256;
constexpr int RT = 256;  // threads of the row kernels
constexpr int FWD = 0, DX = 1, DW = 2;

// A[m, q] of each product (zero outside [0, T): the conv's padding)
template <int MODE>
__device__ __forceinline__ float load_a(const float* __restrict__ A, int m,
                                        int q, int T, int C, int rate,
                                        int left) {
  if (MODE == FWD) {  // m = (b, t), q = (k, c): x[b, t + k*rate - left, c]
    const int b = m / T, t = m - b * T, k = q / C, c = q - k * C;
    const int s = t + k * rate - left;
    return (s >= 0 && s < T) ? A[((size_t)b * T + s) * C + c] : 0.f;
  } else if (MODE == DX) {  // m = (b, t), q = (k, j): dh[b, t - k*rate + left, j]
    const int C2 = 2 * C;
    const int b = m / T, t = m - b * T, k = q / C2, j = q - k * C2;
    const int s = t - k * rate + left;
    return (s >= 0 && s < T) ? A[((size_t)b * T + s) * C2 + j] : 0.f;
  } else {  // m = (k, c), q = (b, t): x[b, t + k*rate - left, c]
    const int k = m / C, c = m - k * C, b = q / T, t = q - b * T;
    const int s = t + k * rate - left;
    return (s >= 0 && s < T) ? A[((size_t)b * T + s) * C + c] : 0.f;
  }
}

// B[q, n] of each product
template <int MODE>
__device__ __forceinline__ float load_b(const float* __restrict__ Bm, int q,
                                        int n, int N, int C) {
  if (MODE == DX) {  // q = (k, j), n = c: W[k, c, j]
    const int C2 = 2 * C, k = q / C2, j = q - k * C2;
    return Bm[((size_t)k * C + n) * C2 + j];
  }
  return Bm[(size_t)q * N + n];  // FWD: W as (K*C, 2C); DW: dh as (B*T, 2C)
}

// out (M, N) = A (M, Q) @ B (Q, N) over q in [z*q_split, (z+1)*q_split):
//   FWD: out = acc + bias;  DX: out += acc;  DW: out[z] = acc (partials)
template <int MODE>
__global__ void __launch_bounds__(GT)
hc_gemm(const float* __restrict__ A, const float* __restrict__ Bm,
        float* __restrict__ out, const float* __restrict__ bias, int M, int N,
        int Q, int q_split, int T, int C, int rate, int left) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = (int)blockIdx.y * BM, n0 = (int)blockIdx.x * BN;
  const int qb = (int)blockIdx.z * q_split, qe = min(Q, qb + q_split);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int q0 = qb; q0 < qe; q0 += BK) {
    // neighbouring threads read neighbouring addresses: along q where the
    // source is contiguous in q, along m (DW's x) or n otherwise
#pragma unroll
    for (int i = 0; i < BM * BK / GT; ++i) {
      const int idx = tid + i * GT;
      const int mm = MODE == DW ? idx % BM : idx / BK;
      const int qq = MODE == DW ? idx / BM : idx % BK;
      const int m = m0 + mm, q = q0 + qq;
      As[qq][mm] = (m < M && q < qe)
                       ? load_a<MODE>(A, m, q, T, C, rate, left) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN * BK / GT; ++i) {
      const int idx = tid + i * GT;
      const int nn = MODE == DX ? idx / BK : idx % BN;
      const int qq = MODE == DX ? idx % BK : idx / BN;
      const int n = n0 + nn, q = q0 + qq;
      Bs[qq][nn] = (n < N && q < qe) ? load_b<MODE>(Bm, q, n, N, C) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* o = MODE == DW ? out + (size_t)blockIdx.z * M * N : out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      const size_t at = (size_t)m * N + n;
      if (MODE == FWD) o[at] = acc[i][j] + bias[n];
      else if (MODE == DX) o[at] += acc[i][j];
      else o[at] = acc[i][j];
    }
  }
}

constexpr int HBK = 32;   // k-tile depth of the bf16 GEMM
constexpr int HLD = 40;   // its shared row pitch in bf16: conflict-free frags

// hc_gemm's product with bf16 operands on the tensor cores (see the top).
// Warp w holds rows (w/4)*64 + [0, 64) and columns (w%4)*32 + [0, 32) of the
// block's 128 x 128 tile as 4 x 4 m16n8 fragments.
template <int MODE>
__global__ void __launch_bounds__(GT)
hc_gemm_bf16(const float* __restrict__ A, const float* __restrict__ Bm,
             float* __restrict__ out, const float* __restrict__ bias, int M,
             int N, int Q, int q_split, int T, int C, int rate, int left) {
  __shared__ __align__(16) bf16 As[BM][HLD];  // m rows, k contiguous
  __shared__ __align__(16) bf16 Bs[BN][HLD];  // n rows, k contiguous
  constexpr int PER = BM * HBK / GT;          // elements of each per thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int m0 = (int)blockIdx.y * BM, n0 = (int)blockIdx.x * BN;
  const int qb = (int)blockIdx.z * q_split, qe = min(Q, qb + q_split);
  // neighbouring threads read neighbouring addresses, as in hc_gemm
  auto a_at = [&](int i, int& mm, int& qq) {
    const int idx = tid + i * GT;
    mm = MODE == DW ? idx % BM : idx / HBK;
    qq = MODE == DW ? idx / BM : idx % HBK;
  };
  auto b_at = [&](int i, int& nn, int& qq) {
    const int idx = tid + i * GT;
    nn = MODE == DX ? idx / HBK : idx % BN;
    qq = MODE == DX ? idx % HBK : idx / BN;
  };
  float ra[PER], rb[PER];
  auto load = [&](int q0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int mm, nn, qa, qn;
      a_at(i, mm, qa);
      b_at(i, nn, qn);
      const int m = m0 + mm, n = n0 + nn, q = q0 + qa, p = q0 + qn;
      ra[i] = (m < M && q < qe) ? load_a<MODE>(A, m, q, T, C, rate, left)
                                : 0.f;
      rb[i] = (n < N && p < qe) ? load_b<MODE>(Bm, p, n, N, C) : 0.f;
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  if (qb < qe) load(qb);
  for (int q0 = qb; q0 < qe; q0 += HBK) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int mm, nn, qa, qn;
      a_at(i, mm, qa);
      b_at(i, nn, qn);
      As[mm][qa] = __float2bfloat16_rn(ra[i]);
      Bs[nn][qn] = __float2bfloat16_rn(rb[i]);
    }
    __syncthreads();
    if (q0 + HBK < qe) load(q0 + HBK);  // in flight during the products

    float part[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HBK; ks += 16) {
      uint32_t bfr[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) frag_b(bfr[nt], Bs, wn + nt * 8 + g,
                                            ks + t2);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t afr[4];
        frag_a(afr, As, wm + mt * 16 + g, ks + t2);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(part[mt][nt], afr, bfr[nt]);
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

  // fragment element q sits at row g (+8 for q >= 2), column t2 (+1 if odd)
  float* o = MODE == DW ? out + (size_t)blockIdx.z * M * N : out;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm + mt * 16 + g + (q >> 1) * 8;
        const int n = n0 + wn + nt * 8 + t2 + (q & 1);
        if (m >= M || n >= N) continue;
        const size_t at = (size_t)m * N + n;
        if (MODE == FWD) o[at] = acc[mt][nt][q] + bias[n];
        else if (MODE == DX) o[at] += acc[mt][nt][q];
        else o[at] = acc[mt][nt][q];
      }
}

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

// mean and 1/sqrt(var + eps) of both C-wide halves of one h row
__device__ __forceinline__ void row_stats(const float* __restrict__ hr, int C,
                                          float eps, float* red, float& mu1,
                                          float& inv1, float& mu2,
                                          float& inv2) {
  float s[2] = {0.f, 0.f};
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s[0] += hr[c];
    s[1] += hr[C + c];
  }
  block_sum<2>(s, red);
  mu1 = s[0] / C;
  mu2 = s[1] / C;
  float v[2] = {0.f, 0.f};
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d1 = hr[c] - mu1, d2 = hr[C + c] - mu2;
    v[0] += d1 * d1;
    v[1] += d2 * d2;
  }
  block_sum<2>(v, red);
  inv1 = rsqrtf(v[0] / C + eps);
  inv2 = rsqrtf(v[1] / C + eps);
}

__global__ void __launch_bounds__(RT)
hc_fwd_rows(const float* __restrict__ h, const float* __restrict__ x,
            const float* __restrict__ g1, const float* __restrict__ be1,
            const float* __restrict__ g2, const float* __restrict__ be2,
            float* __restrict__ y, int C, float eps) {
  __shared__ float red[2 * 32];
  const size_t row = blockIdx.x;
  const float* hr = h + row * 2 * C;
  float mu1, inv1, mu2, inv2;
  row_stats(hr, C, eps, red, mu1, inv1, mu2, inv2);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float g = sigmoidf((hr[c] - mu1) * inv1 * g1[c] + be1[c]);
    const float h2 = (hr[C + c] - mu2) * inv2 * g2[c] + be2[c];
    y[row * C + c] = g * h2 + (1.f - g) * x[row * C + c];
  }
}

// Rows [chunk*R, chunk*R + R) of the backward's elementwise part. Shared
// memory: the chunk's column sums acc[6C] = db (2C) | dgamma1 | dbeta1 |
// dgamma2 | dbeta2, then one row's n1, n2, dn1, dn2 (C each). A thread owns
// the columns c = threadIdx.x + i*blockDim.x in every array, so only the
// row reductions synchronise.
__global__ void __launch_bounds__(RT)
hc_bwd_rows(const float* __restrict__ h, const float* __restrict__ x,
            const float* __restrict__ dy, const float* __restrict__ g1,
            const float* __restrict__ be1, const float* __restrict__ g2,
            const float* __restrict__ be2, float* __restrict__ dh,
            float* __restrict__ dx, float* __restrict__ part, int M, int C,
            float eps, int R) {
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
    row_stats(hr, C, eps, red, mu1, inv1, mu2, inv2);
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
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
    const float m1 = s[0] / C, m1n = s[1] / C, m2 = s[2] / C, m2n = s[3] / C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float da = inv1 * (dn1s[c] - m1 - n1s[c] * m1n);
      const float db = inv2 * (dn2s[c] - m2 - n2s[c] * m2n);
      dh[row * 2 * C + c] = da;
      dh[row * 2 * C + C + c] = db;
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

// the product on the float32 FMA units, or with bf16 operands on the tensor
// cores; row ranges of q_split a multiple of the k-tile (a range past Q
// writes a zero partial)
template <int MODE>
cudaError_t gemm(const float* A, const float* Bm, float* out,
                 const float* bias, int M, int N, int Q, int splits, int T,
                 int C, int rate, int left, bool bf16_ops, cudaStream_t st) {
  const int depth = bf16_ops ? HBK : BK;
  int q_split = (Q + splits - 1) / splits;
  q_split = (q_split + depth - 1) / depth * depth;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (bf16_ops)
    hc_gemm_bf16<MODE><<<grid, GT, 0, st>>>(A, Bm, out, bias, M, N, Q,
                                            q_split, T, C, rate, left);
  else
    hc_gemm<MODE><<<grid, GT, 0, st>>>(A, Bm, out, bias, M, N, Q, q_split,
                                       T, C, rate, left);
  return cudaGetLastError();
}

bool bad_geometry(int Bn, int T, int C, int K, int rate, int left) {
  return Bn < 1 || T < 1 || C < 1 || K < 1 || rate < 1 || left < 0 ||
         left > (K - 1) * rate || (size_t)Bn * T * 2 * C >= (1u << 31);
}

}  // namespace

// y = HC(x). h: (B*T, 2C) scratch. bf16_ops: the tap product's operands in
// bf16 on the tensor cores.
extern "C" int dctts_hc_fwd(const float* x, const float* w, const float* b,
                            const float* g1, const float* be1,
                            const float* g2, const float* be2, float* h,
                            float* y, int Bn, int T, int C, int K, int rate,
                            int left, float eps, int bf16_ops,
                            void* stream) {
  if (bad_geometry(Bn, T, C, K, rate, left))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = Bn * T;
  cudaError_t e = gemm<FWD>(x, w, h, b, M, 2 * C, K * C, 1, T, C, rate, left,
                            bf16_ops != 0, st);
  if (e != cudaSuccess) return (int)e;
  hc_fwd_rows<<<M, RT, 0, st>>>(h, x, g1, be1, g2, be2, y, C, eps);
  return (int)cudaGetLastError();
}

// Gradients of HC at (x, params) for the cotangent dy. Scratch: h, dh (B*T,
// 2C); row_part (ceil(B*T/R), 6C); dw_part (dw_splits, K*C*2C), unused
// when dw_splits == 1. dparams (6C) = db (2C) | dg1 | dbe1 | dg2 | dbe2.
// bf16_ops: the three tap products' operands in bf16 on the tensor cores.
extern "C" int dctts_hc_bwd(const float* x, const float* w, const float* b,
                            const float* g1, const float* be1,
                            const float* g2, const float* be2,
                            const float* dy, float* h, float* dh, float* dx,
                            float* dw, float* dparams, float* row_part,
                            float* dw_part, int Bn, int T, int C, int K,
                            int rate, int left, float eps, int R,
                            int dw_splits, int bf16_ops, void* stream) {
  if (bad_geometry(Bn, T, C, K, rate, left) || R < 1 || dw_splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool lo = bf16_ops != 0;
  const int M = Bn * T, n_chunks = (M + R - 1) / R;
  const size_t smem = sizeof(float) * (10 * (size_t)C + 4 * 32);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(hc_bwd_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if ((e = gemm<FWD>(x, w, h, b, M, 2 * C, K * C, 1, T, C, rate, left, lo,
                     st)) != cudaSuccess)
    return (int)e;
  hc_bwd_rows<<<n_chunks, RT, smem, st>>>(h, x, dy, g1, be1, g2, be2, dh, dx,
                                          row_part, M, C, eps, R);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t L6 = 6 * (size_t)C;
  hc_col_sum<<<(unsigned)((L6 + 255) / 256), 256, 0, st>>>(row_part,
                                                           n_chunks, L6,
                                                           dparams);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = gemm<DX>(dh, w, dx, nullptr, M, C, K * 2 * C, 1, T, C, rate, left,
                    lo, st)) != cudaSuccess)
    return (int)e;
  float* dw_out = dw_splits == 1 ? dw : dw_part;
  if ((e = gemm<DW>(x, dh, dw_out, nullptr, K * C, 2 * C, M, dw_splits, T, C,
                    rate, left, lo, st)) != cudaSuccess)
    return (int)e;
  if (dw_splits > 1) {
    const size_t LW = (size_t)K * C * 2 * C;
    hc_col_sum<<<(unsigned)((LW + 255) / 256), 256, 0, st>>>(dw_part,
                                                             dw_splits, LW,
                                                             dw);
  }
  return (int)cudaGetLastError();
}
