// Kernel K5: an SSRN block in synthesis, the elementwise chain around its
// three bf16 products, as one prologue and one epilogue launch.
//
// Replaces no TPU kernel: on the TPU, XLA fused this chain (the taps'
// shifts, the hi/lo split, the sums of the products, the bias, the layer
// norms, the gate and the highway mix) into the products of each block.
// Eager PyTorch runs it as ~20-80 kernels a block, each a pass over the
// block's activations. The design note is in dc_tts_tpu_torch/ops/
// ssrn_block.py. The products stay torch.mm / torch.addmm calls on the
// tensor cores between the two launches.
//
// Bound on the H100: bytes. The prologue reads x once and writes the bf16
// hi and lo halves of the gathered taps once; the epilogue reads the summed
// product once (an HC block also x) and writes y once. Both keep everything
// else in registers: the prologue one row of taps at a time, the epilogue
// one row of the product with its layer-norm statistics.
//
//   ssrn_prologue_kernel  x (B, T, C) float32 -> hi, lo (rows, Kp) bf16:
//     one block a row; each thread 4 consecutive columns. "concat" rows
//     (C and HC blocks) are time steps m = b*T + t holding the S taps side
//     by side, tap k at columns [k*C, (k+1)*C), reading x[b, t + off0 +
//     k*step] (zero outside [0, T)); "separate" rows (D blocks) hold one
//     tap each, tap k in rows [k*M, (k+1)*M). Columns past the taps are
//     zero up to Kp, a multiple of 8, so every row starts 16-byte aligned
//     (cuBLAS's fast kernels need it). hi = bf16(v) and lo = bf16(v - hi),
//     both rounded to nearest even (dsp/stft.split_bf16).
//   ssrn_epilogue_kernel  the products' float32 sums -> y float32: one
//     block a row m, V values of each of up to two layer-norm segments a
//     thread (columns j = threadIdx.x + i*K5_NT), the statistics reduced
//     over the block. C: LN(P + b), then the activation. HC: h1 = P[:, :W]
//     + b1 and h2 = P[:, W:2W] + b2 each normalised; y = s*h2 + (1 - s)*x,
//     s = sigmoid(h1). D: even = (E0 + E2) + b and odd = E1 + b to rows 2m
//     and 2m + 1 of y, each normalised, then the activation. The
//     activation is none or ReLU (SSRN's blocks use no other).
//
// The arithmetic is the eager chain's, operation for operation, rounded to
// nearest at each (the _rn intrinsics: no contraction into FMAs): mean =
// sum * (1/W), var = sum((v - mean)^2) * (1/W), ((v - mean) * rsqrt(var +
// eps)) * gamma + beta, the gate 1 / (1 + exp(-v)). Only the order of the
// layer norms' sums differs. No fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define K5_NT 256    // threads of an epilogue block
#define K5_MAXV 16   // values of a segment a thread: W <= 4096

namespace {

enum Kind { KIND_C = 0, KIND_HC = 1, KIND_D = 2 };
enum Act { ACT_NONE = 0, ACT_RELU = 1 };

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

__global__ void __launch_bounds__(K5_NT)
ssrn_prologue_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ hi,
                     __nv_bfloat16* __restrict__ lo, int M, int T, int C,
                     int S, int off0, int step, int separate, int Kp,
                     int vec) {
  const int r = blockIdx.x;
  const int k_row = separate ? r / M : 0;
  const int m = r - k_row * M;
  const int t = m % T;
  const float* xb = x + (size_t)(m - t) * C;   // row 0 of this utterance
  const int width = separate ? C : S * C;
  uint2* hrow = reinterpret_cast<uint2*>(hi + (size_t)r * Kp);
  uint2* lrow = reinterpret_cast<uint2*>(lo + (size_t)r * Kp);
  for (int j = 4 * threadIdx.x; j < Kp; j += 4 * blockDim.x) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (vec && j < width) {
      // C % 4 == 0: the four columns lie in one tap
      const int k = separate ? k_row : j / C;
      const int ts = t + off0 + k * step;
      if (ts >= 0 && ts < T) {
        const float4 q = *reinterpret_cast<const float4*>(
            xb + (size_t)ts * C + (j - (separate ? 0 : k * C)));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = j + e;
        if (jj < width) {
          const int k = separate ? k_row : jj / C;
          const int ts = t + off0 + k * step;
          if (ts >= 0 && ts < T)
            v[e] = xb[(size_t)ts * C + (jj - (separate ? 0 : k * C))];
        }
      }
    }
    __nv_bfloat16 h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = __float2bfloat16_rn(v[e]);
      l[e] = __float2bfloat16_rn(__fsub_rn(v[e], __bfloat162float(h[e])));
    }
    hrow[j >> 2] = make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
    lrow[j >> 2] = make_uint2(pack2(l[0], l[1]), pack2(l[2], l[3]));
  }
}

// The sum of (a, b) over the block, the same bits in every thread: a warp's
// lanes pairwise over xor distances 16..1, then the warps' sums in order.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();   // red's previous use is read by every thread
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 s = red[0];
#pragma unroll
  for (int w = 1; w < K5_NT / 32; ++w) {
    s.x += red[w].x;
    s.y += red[w].y;
  }
  return s;
}

__device__ __forceinline__ float activate(float v, int act) {
  return act == ACT_RELU ? fmaxf(v, 0.f) : v;
}

__device__ __forceinline__ float norm(float d, float r, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(d, r), g), b);
}

template <int V>
__global__ void __launch_bounds__(K5_NT)
ssrn_epilogue_kernel(int kind, const float* __restrict__ p0,
                     const float* __restrict__ p1,
                     const float* __restrict__ p2,
                     const float* __restrict__ bias,
                     const float* __restrict__ g1, const float* __restrict__ b1,
                     const float* __restrict__ g2, const float* __restrict__ b2,
                     const float* __restrict__ x, float* __restrict__ y, int W,
                     int ldp, int act, float eps) {
  __shared__ float2 red[K5_NT / 32];
  const int m = blockIdx.x;
  const size_t row = (size_t)m * ldp;
  float a[V], c[V];
  float sa = 0.f, sc = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = threadIdx.x + i * K5_NT;
    a[i] = c[i] = 0.f;
    if (j < W) {
      if (kind == KIND_C) {
        a[i] = __fadd_rn(p0[row + j], bias[j]);
      } else if (kind == KIND_HC) {
        a[i] = __fadd_rn(p0[row + j], bias[j]);
        c[i] = __fadd_rn(p0[row + W + j], bias[W + j]);
      } else {
        a[i] = __fadd_rn(__fadd_rn(p0[row + j], p1[row + j]), bias[j]);
        c[i] = __fadd_rn(p2[row + j], bias[j]);
      }
    }
    sa += a[i];
    sc += c[i];
  }
  const float inv = 1.f / (float)W;
  float2 s = block_sum2(sa, sc, red);
  const float ma = __fmul_rn(s.x, inv), mc = __fmul_rn(s.y, inv);
  sa = sc = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const bool in = threadIdx.x + i * K5_NT < W;
    a[i] = in ? __fsub_rn(a[i], ma) : 0.f;
    c[i] = in ? __fsub_rn(c[i], mc) : 0.f;
    sa = __fadd_rn(sa, __fmul_rn(a[i], a[i]));
    sc = __fadd_rn(sc, __fmul_rn(c[i], c[i]));
  }
  s = block_sum2(sa, sc, red);
  const float ra = rsqrtf(__fadd_rn(__fmul_rn(s.x, inv), eps));
  const float rc = rsqrtf(__fadd_rn(__fmul_rn(s.y, inv), eps));
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = threadIdx.x + i * K5_NT;
    if (j >= W) continue;
    if (kind == KIND_C) {
      y[(size_t)m * W + j] = activate(norm(a[i], ra, g1[j], b1[j]), act);
    } else if (kind == KIND_HC) {
      const float h1 = norm(a[i], ra, g1[j], b1[j]);
      const float h2 = norm(c[i], rc, g2[j], b2[j]);
      const float g = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-h1)));
      const size_t o = (size_t)m * W + j;
      y[o] = __fadd_rn(__fmul_rn(g, h2),
                       __fmul_rn(__fsub_rn(1.f, g), x[o]));
    } else {
      y[(size_t)(2 * m) * W + j] = activate(norm(a[i], ra, g1[j], b1[j]), act);
      y[(size_t)(2 * m + 1) * W + j] =
          activate(norm(c[i], rc, g1[j], b1[j]), act);
    }
  }
}

template <int V>
cudaError_t epilogue_launch(int kind, const float* p0, const float* p1,
                            const float* p2, const float* bias,
                            const float* g1, const float* b1, const float* g2,
                            const float* b2, const float* x, float* y, int M,
                            int W, int ldp, int act, float eps,
                            cudaStream_t st) {
  ssrn_epilogue_kernel<V><<<M, K5_NT, 0, st>>>(kind, p0, p1, p2, bias, g1, b1,
                                               g2, b2, x, y, W, ldp, act, eps);
  return cudaGetLastError();
}

}  // namespace

// x (B, T, C) float32 -> the taps' bf16 halves hi, lo: rows of Kp values,
// B*T rows ("concat": S taps side by side) or S*B*T rows ("separate"). vec:
// C % 4 == 0 and x 16-byte aligned (float4 loads).
extern "C" int dctts_ssrn_prologue(const float* x, void* hi, void* lo, int B,
                                   int T, int C, int S, int off0, int step,
                                   int separate, int Kp, int vec,
                                   void* stream) {
  if (B < 1 || T < 1 || C < 1 || S < 1 || Kp < 4 || Kp % 4 != 0 ||
      Kp < (separate ? C : S * C) || (vec && C % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const int M = B * T, rows = separate ? S * M : M;
  int threads = (Kp / 4 + 31) / 32 * 32;
  if (threads > K5_NT) threads = K5_NT;
  ssrn_prologue_kernel<<<rows, threads, 0, (cudaStream_t)stream>>>(
      x, (__nv_bfloat16*)hi, (__nv_bfloat16*)lo, M, T, C, S, off0, step,
      separate, Kp, vec);
  return (int)cudaGetLastError();
}

// The block's tail over M rows (kind 0 C, 1 HC, 2 D), W values a layer-norm
// segment, the products' rows ldp apart; p1, p2 (D's E2 and E1), g2, b2
// (HC's second norm) and x (HC's input) may be null where unused.
extern "C" int dctts_ssrn_epilogue(int kind, const float* p0, const float* p1,
                                   const float* p2, const float* bias,
                                   const float* g1, const float* b1,
                                   const float* g2, const float* b2,
                                   const float* x, float* y, int M, int W,
                                   int ldp, int act, float eps, void* stream) {
  const int need = kind == KIND_HC ? 2 * W : W;
  if (M < 1 || W < 1 || W > K5_NT * K5_MAXV || ldp < need || kind < 0 ||
      kind > 2 || act < 0 || act > 1 ||
      (kind == KIND_HC && (!g2 || !b2 || !x)) ||
      (kind == KIND_D && (!p1 || !p2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the fewest values a thread that cover W: 2, 4 and 5 at base_config's
  // widths (512, 1024, 1025)
  const int v = (W + K5_NT - 1) / K5_NT;
#define K5_LAUNCH(n)                                                      \
  return (int)epilogue_launch<n>(kind, p0, p1, p2, bias, g1, b1, g2, b2, \
                                 x, y, M, W, ldp, act, eps, st)
  if (v <= 1) K5_LAUNCH(1);
  if (v <= 2) K5_LAUNCH(2);
  if (v <= 4) K5_LAUNCH(4);
  if (v <= 5) K5_LAUNCH(5);
  if (v <= 8) K5_LAUNCH(8);
  K5_LAUNCH(16);
#undef K5_LAUNCH
}
