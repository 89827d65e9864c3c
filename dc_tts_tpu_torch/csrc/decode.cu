// Kernel K1: the whole Text2Mel autoregressive decode in one launch.
//
// Replaces dc_tts_tpu/ops/pallas_decode.py:fused_decode (body
// _decode_kernel). The design note is in dc_tts_tpu_torch/ops/decode.py:
// one 512-thread block owns DECODE_ROWS batch rows and runs all T steps;
// activations in shared memory, HC ring buffers in a global scratch, each
// thread owns one output column of a layer and streams that column of the
// weights once per step. Bound on the H100: every step streams the ~29 MB
// of packed weights from L2 into each block.
//
// Numerics follow the float32 reference: no fast math, sigmoid as
// 1/(1+expf(-x)), layer norm (x-mu)*rsqrt(var+eps) with the biased
// variance, the attention cursor the FIRST argmax of the softmax output.
//
// The precisions of the JAX kernel's layer products (its mm), one kernel
// with the mode a launch argument: MODE_HIGHEST float32 FFMA; MODE_HIGH3
// the bf16 split xh@Wh + xh@Wl + xl@Wh with the weights' hi/lo halves
// split in Python (same bytes as float32) and the activations split once
// per layer into shared memory (round to nearest even), three float32
// accumulators a row summed as (hh + hl) + lh; MODE_HYBRID the split in
// AudioDec only (its layers' halves in their own arrays, indexed from the
// first AudioDec layer), float32 in AudioEnc; MODE_DEFAULT one pass over
// bf16 weights (half the bytes) and rounded activations, float32 sums. A
// product of two bf16 values is exact in float32, so FFMA on the widened
// halves gives the tensor core's products; only the order of the sums
// differs. The tensor cores would waste 12 of mma.sync's 16 rows at 4 rows
// a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define DECODE_ROWS 4   // batch rows per block; ROWS in ops/decode.py
#define NT 512          // threads per block
#define MAX_LAYERS 32
#define MAX_WIN 8

#define MODE_HIGHEST 0  // PRECS in ops/decode.py, in order
#define MODE_HIGH3 1
#define MODE_HYBRID 2
#define MODE_DEFAULT 3

namespace {

typedef unsigned short bf16_t;  // bf16 bits

struct Layer {
  int kind;  // 0 = C, 1 = HC
  int idx;   // index into the packed arrays of its kind
  int cin, cout, rate;
  int act;   // 0 none, 1 relu, 2 sigmoid
  int ring_off;  // first ring row of an HC layer
};

struct Program {
  int n_enc, n_dec;
  Layer l[MAX_LAYERS];
};

struct Args {
  const float* kt;    // (B, N, d)
  const float* v;     // (B, N, d)
  const float* cw;    // (n_c, cmi, cmo); HIGHEST and HYBRID
  const float* cb;    // (n_c, cmo)
  const float* cln;   // (n_c, 2, cmo)
  const float* hcw;   // (n_hc, 3d, 2d); HIGHEST and HYBRID
  const float* hcb;   // (n_hc, 2d)
  const float* hcln;  // (n_hc, 4, d)
  // bf16 kernels: HIGH3 (2, n_c, cmi, cmo) hi/lo; HYBRID (2, n_c - c_base,
  // cmi, cmo) hi/lo of AudioDec's layers; DEFAULT (n_c, cmi, cmo). The
  // same for hcws with (3d, 2d) slots.
  const bf16_t* cws;
  const bf16_t* hcws;
  float* y;           // (B, T, n_mels)
  float* a;           // (B, N, T)
  float* ring;        // (B padded to DECODE_ROWS, ring_rows, d)
  int B, N, d, n_mels, T, win, cmi, cmo, ring_rows, xw;
  int mode, c_base, hc_base;  // first packed index the bf16 arrays hold
  int c_lo, hc_lo;            // elements from a hi half to its lo half
  float eps, scale;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// out[r*ldo + j] = sum_k in[r*ldi + k] * W[k*ldw + j] + bias[j] for the
// block's rows; thread j owns column j (and j + NT, ...). The weights come
// from L2 in groups of KU independent loads, so that enough are in flight
// to cover the latency; the sum over k stays in order. in and ldi must be
// 16-byte aligned (float4 reads of the activations).
#define KU 16
__device__ void rows_matmul(const float* in, int ldi, int K,
                            const float* __restrict__ W, int ldw,
                            const float* __restrict__ bias, int cout,
                            float* out, int ldo) {
  for (int j = threadIdx.x; j < cout; j += NT) {
    float acc[DECODE_ROWS];
#pragma unroll
    for (int r = 0; r < DECODE_ROWS; ++r) acc[r] = 0.f;
    const float* wp = W + j;
    int k = 0;
    for (; k + KU <= K; k += KU) {
      float w[KU];
#pragma unroll
      for (int u = 0; u < KU; ++u) w[u] = __ldg(wp + (size_t)(k + u) * ldw);
#pragma unroll
      for (int r = 0; r < DECODE_ROWS; ++r) {
        const float4* a = reinterpret_cast<const float4*>(in + r * ldi + k);
#pragma unroll
        for (int u4 = 0; u4 < KU / 4; ++u4) {
          const float4 v = a[u4];
          acc[r] = fmaf(v.x, w[4 * u4], acc[r]);
          acc[r] = fmaf(v.y, w[4 * u4 + 1], acc[r]);
          acc[r] = fmaf(v.z, w[4 * u4 + 2], acc[r]);
          acc[r] = fmaf(v.w, w[4 * u4 + 3], acc[r]);
        }
      }
    }
    for (; k < K; ++k) {
      const float w = __ldg(wp + (size_t)k * ldw);
#pragma unroll
      for (int r = 0; r < DECODE_ROWS; ++r)
        acc[r] = fmaf(in[r * ldi + k], w, acc[r]);
    }
    const float b = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < DECODE_ROWS; ++r) out[r * ldo + j] = acc[r] + b;
  }
}

__device__ __forceinline__ float bf2f(unsigned bits16) {
  return __uint_as_float(bits16 << 16);
}

// rows_matmul on bf16 operands: the block's input rows are rounded (to
// nearest even) into xs once, hi at xs and, with THREE, the lo halves
// bf16(x - hi) at xs + DECODE_ROWS * ldx; thread j streams column j of Wh
// (and Wl). THREE: out = (xh@Wh + xh@Wl) + xl@Wh, each product summed over
// k in order in its own float32 accumulator; else out = xh@Wh. xs must be
// 16-byte aligned; every thread of the block must call this (it
// synchronises once, after the split).
template <bool THREE>
__device__ void rows_matmul_bf16(const float* in, int ldi, int K,
                                 const bf16_t* __restrict__ Wh,
                                 const bf16_t* __restrict__ Wl, int ldw,
                                 const float* __restrict__ bias, int cout,
                                 float* out, int ldo, bf16_t* xs) {
  const int ldx = (K + 7) & ~7;  // rows of 16-byte multiples
  bf16_t* xh = xs;
  bf16_t* xl = xs + DECODE_ROWS * ldx;
  for (int i = threadIdx.x; i < DECODE_ROWS * K; i += NT) {
    const int r = i / K, k = i % K;
    const float v = in[r * ldi + k];
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    xh[r * ldx + k] = __bfloat16_as_ushort(h);
    if (THREE)
      xl[r * ldx + k] = __bfloat16_as_ushort(
          __float2bfloat16_rn(v - __bfloat162float(h)));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cout; j += NT) {
    float hh[DECODE_ROWS], hl[DECODE_ROWS], lh[DECODE_ROWS];
#pragma unroll
    for (int r = 0; r < DECODE_ROWS; ++r) hh[r] = hl[r] = lh[r] = 0.f;
    const bf16_t* wph = Wh + j;
    const bf16_t* wpl = Wl + j;
    int k = 0;
    for (; k + KU <= K; k += KU) {
      float wh[KU], wl[KU];
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        wh[u] = bf2f(__ldg(wph + (size_t)(k + u) * ldw));
        if (THREE) wl[u] = bf2f(__ldg(wpl + (size_t)(k + u) * ldw));
      }
#pragma unroll
      for (int r = 0; r < DECODE_ROWS; ++r) {
        const uint4* ah = reinterpret_cast<const uint4*>(xh + r * ldx + k);
        const uint4* al = reinterpret_cast<const uint4*>(xl + r * ldx + k);
#pragma unroll
        for (int v8 = 0; v8 < KU / 8; ++v8) {
          // two bf16 a word, the lower address in the low half
          const uint4 qh = ah[v8];
          const unsigned xh2[4] = {qh.x, qh.y, qh.z, qh.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int u = 8 * v8 + 2 * e;
            const float x0 = __uint_as_float(xh2[e] << 16);
            const float x1 = __uint_as_float(xh2[e] & 0xffff0000u);
            hh[r] = fmaf(x0, wh[u], hh[r]);
            hh[r] = fmaf(x1, wh[u + 1], hh[r]);
            if (THREE) {
              hl[r] = fmaf(x0, wl[u], hl[r]);
              hl[r] = fmaf(x1, wl[u + 1], hl[r]);
            }
          }
          if (THREE) {
            const uint4 ql = al[v8];
            const unsigned xl2[4] = {ql.x, ql.y, ql.z, ql.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int u = 8 * v8 + 2 * e;
              lh[r] = fmaf(__uint_as_float(xl2[e] << 16), wh[u], lh[r]);
              lh[r] = fmaf(__uint_as_float(xl2[e] & 0xffff0000u), wh[u + 1],
                           lh[r]);
            }
          }
        }
      }
    }
    for (; k < K; ++k) {
      const float wh = bf2f(__ldg(wph + (size_t)k * ldw));
      const float wl = THREE ? bf2f(__ldg(wpl + (size_t)k * ldw)) : 0.f;
#pragma unroll
      for (int r = 0; r < DECODE_ROWS; ++r) {
        const float x0 = bf2f(xh[r * ldx + k]);
        hh[r] = fmaf(x0, wh, hh[r]);
        if (THREE) {
          hl[r] = fmaf(x0, wl, hl[r]);
          lh[r] = fmaf(bf2f(xl[r * ldx + k]), wh, lh[r]);
        }
      }
    }
    const float b = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < DECODE_ROWS; ++r)
      out[r * ldo + j] = (THREE ? (hh[r] + hl[r]) + lh[r] : hh[r]) + b;
  }
}

// The product of packed layer idx of kind (0 C, 1 HC), in the launch's
// mode; dec: the layer is AudioDec's. in (rows of K) -> out (cout columns)
// + bias.
__device__ void layer_mm(const Args& p, int kind, int idx, bool dec,
                         const float* in, int ldi, int K, int cout,
                         float* out, int ldo, bf16_t* xs) {
  const size_t slot =
      kind == 0 ? (size_t)p.cmi * p.cmo : (size_t)6 * p.d * p.d;
  const int ldw = kind == 0 ? p.cmo : 2 * p.d;
  const float* bias = (kind == 0 ? p.cb + (size_t)idx * p.cmo
                                 : p.hcb + (size_t)idx * 2 * p.d);
  if (p.mode == MODE_HIGHEST || (p.mode == MODE_HYBRID && !dec)) {
    const float* w = (kind == 0 ? p.cw : p.hcw) + idx * slot;
    rows_matmul(in, ldi, K, w, ldw, bias, cout, out, ldo);
  } else if (p.mode == MODE_DEFAULT) {
    const bf16_t* w = (kind == 0 ? p.cws : p.hcws) + idx * slot;
    rows_matmul_bf16<false>(in, ldi, K, w, w, ldw, bias, cout, out, ldo, xs);
  } else {
    const int base =
        p.mode == MODE_HYBRID ? (kind == 0 ? p.c_base : p.hc_base) : 0;
    const bf16_t* wh = (kind == 0 ? p.cws : p.hcws) + (idx - base) * slot;
    const bf16_t* wl = wh + (kind == 0 ? p.c_lo : p.hc_lo);
    rows_matmul_bf16<true>(in, ldi, K, wh, wl, ldw, bias, cout, out, ldo, xs);
  }
}

// Layer-norm statistics of nseg segments of `width` columns per row:
// stats[(r*nseg + s)*2] = mean, [+1] = rsqrt(var + eps). One warp a segment.
__device__ void ln_stats(const float* buf, int ld, int width, int nseg,
                         float eps, float* stats) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int task = warp; task < DECODE_ROWS * nseg; task += NT / 32) {
    const float* x = buf + (task / nseg) * ld + (task % nseg) * width;
    float s = 0.f;
    for (int c = lane; c < width; c += 32) s += x[c];
    const float mean = warp_sum(s) / (float)width;
    float q = 0.f;
    for (int c = lane; c < width; c += 32) {
      const float dl = x[c] - mean;
      q += dl * dl;
    }
    const float var = warp_sum(q) / (float)width;
    if (lane == 0) {
      stats[task * 2] = mean;
      stats[task * 2 + 1] = rsqrtf(var + eps);
    }
  }
}

// C layer: x <- act(LN(x @ W + b)); tmp is scratch of the same shape.
__device__ void run_c(const Args& p, const Layer& L, bool dec, float* x,
                      float* tmp, float* stats, bf16_t* xs) {
  layer_mm(p, 0, L.idx, dec, x, p.xw, L.cin, L.cout, tmp, p.xw, xs);
  __syncthreads();
  ln_stats(tmp, p.xw, L.cout, 1, p.eps, stats);
  __syncthreads();
  const float* gamma = p.cln + (size_t)L.idx * 2 * p.cmo;
  const float* beta = gamma + p.cmo;
  for (int i = threadIdx.x; i < DECODE_ROWS * L.cout; i += NT) {
    const int r = i / L.cout, c = i % L.cout;
    float h = (tmp[r * p.xw + c] - stats[r * 2]) * stats[r * 2 + 1] * gamma[c]
              + beta[c];
    if (L.act == 1) h = fmaxf(h, 0.f);
    else if (L.act == 2) h = sigmoidf(h);
    x[r * p.xw + c] = h;
  }
  __syncthreads();
}

// HC layer at step t: ring row t mod R <- x; taps = [x_{t-2r}, x_{t-r}, x];
// h = taps @ W + b; x <- sigmoid(LN1(h1)) * LN2(h2) + (1 - sigmoid) * x.
__device__ void run_hc(const Args& p, const Layer& L, bool dec, int t,
                       int b0, float* x, float* taps, float* hs, float* stats,
                       bf16_t* xs) {
  const int C = L.cout, R = 2 * L.rate + 1;
  const int wi = t % R, i0 = (t + 1) % R, i1 = (t + L.rate + 1) % R;
  for (int i = threadIdx.x; i < DECODE_ROWS * C; i += NT) {
    const int r = i / C, c = i % C;
    float* ring = p.ring + ((size_t)(b0 + r) * p.ring_rows + L.ring_off) * C;
    const float xv = x[r * p.xw + c];
    ring[wi * C + c] = xv;
    float* tp = taps + r * 3 * C;
    tp[c] = ring[i0 * C + c];
    tp[C + c] = ring[i1 * C + c];
    tp[2 * C + c] = xv;
  }
  __syncthreads();
  layer_mm(p, 1, L.idx, dec, taps, 3 * C, 3 * C, 2 * C, hs, 2 * C, xs);
  __syncthreads();
  ln_stats(hs, 2 * C, C, 2, p.eps, stats);
  __syncthreads();
  const float* ln = p.hcln + (size_t)L.idx * 4 * C;
  for (int i = threadIdx.x; i < DECODE_ROWS * C; i += NT) {
    const int r = i / C, c = i % C;
    const float* st = stats + r * 4;
    const float g = sigmoidf((hs[r * 2 * C + c] - st[0]) * st[1] * ln[c]
                             + ln[C + c]);
    const float h2 = (hs[r * 2 * C + C + c] - st[2]) * st[3] * ln[2 * C + c]
                     + ln[3 * C + c];
    x[r * p.xw + c] = g * h2 + (1.f - g) * x[r * p.xw + c];
  }
  __syncthreads();
}

__device__ void run_stack(const Args& p, const Program& prog, int first,
                          int count, bool dec, int t, int b0, float* x,
                          float* tmp, float* taps, float* hs, float* stats,
                          bf16_t* xs) {
  for (int li = first; li < first + count; ++li) {
    const Layer& L = prog.l[li];
    if (L.kind == 0) run_c(p, L, dec, x, tmp, stats, xs);
    else run_hc(p, L, dec, t, b0, x, taps, hs, stats, xs);
  }
}

// One attention row per batch row (warp r): scores of the <= win unmasked
// keys, softmax (the masked keys' exp(NEG_INF - max) is exactly 0),
// new cursor = first argmax, ctx = a.V. Writes out = [ctx; q] and column t
// of A.
__device__ void attention(const Args& p, int t, int b0, const float* q,
                          float* out, int* prev) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d = p.d;
  if (warp < DECODE_ROWS) {
    const int r = warp, b = b0 + r;
    const float* qr = q + r * p.xw;
    float* o = out + r * p.xw;
    if (b < p.B) {
      const int pv = prev[r];
      const int nw = min(p.win, p.N - pv);
      float s[MAX_WIN];
      float m = -INFINITY;
      for (int w = 0; w < nw; ++w) {
        const float* k = p.kt + ((size_t)b * p.N + pv + w) * d;
        float part = 0.f;
        for (int c = lane; c < d; c += 32) part = fmaf(k[c], qr[c], part);
        s[w] = warp_sum(part) * p.scale;
        m = fmaxf(m, s[w]);
      }
      float sum = 0.f;
      for (int w = 0; w < nw; ++w) {
        s[w] = expf(s[w] - m);
        sum += s[w];
      }
      float best = -1.f;
      int bi = 0;
      for (int w = 0; w < nw; ++w) {
        s[w] = s[w] / sum;
        if (s[w] > best) {  // strict: the first maximum wins
          best = s[w];
          bi = w;
        }
      }
      for (int c = lane; c < d; c += 32) {
        float acc = 0.f;
        for (int w = 0; w < nw; ++w)
          acc = fmaf(s[w], p.v[((size_t)b * p.N + pv + w) * d + c], acc);
        o[c] = acc;
        o[d + c] = qr[c];
      }
      float* acol = p.a + (size_t)b * p.N * p.T + t;
      for (int n = lane; n < p.N; n += 32) {
        const int w = n - pv;
        float v = 0.f;
        for (int u = 0; u < nw; ++u)
          if (u == w) v = s[u];
        acol[(size_t)n * p.T] = v;
      }
      __syncwarp();
      if (lane == 0) prev[r] = pv + bi;
    } else {
      for (int c = lane; c < 2 * d; c += 32) o[c] = 0.f;
    }
  }
  __syncthreads();
}

// __grid_constant__: the device functions take these by reference without
// a per-thread local copy
__global__ void __launch_bounds__(NT)
decode_kernel(const __grid_constant__ Args p,
              const __grid_constant__ Program prog) {
  extern __shared__ float smem[];
  __shared__ int prev[DECODE_ROWS];
  float* cur = smem;                              // ROWS x xw
  float* alt = cur + DECODE_ROWS * p.xw;          // ROWS x xw
  float* taps = alt + DECODE_ROWS * p.xw;         // ROWS x 3d
  float* hs = taps + DECODE_ROWS * 3 * p.d;       // ROWS x 2d
  float* stats = hs + DECODE_ROWS * 2 * p.d;      // ROWS x 4
  // the bf16 split of a layer's input rows: 2 x ROWS x ldx_max, 16-byte
  // aligned (every region above is a multiple of 4 floats)
  bf16_t* xs = reinterpret_cast<bf16_t*>(stats + DECODE_ROWS * 4);
  const int b0 = blockIdx.x * DECODE_ROWS;

  // the ring buffers start at zero: the causal left padding
  const size_t nring = (size_t)DECODE_ROWS * p.ring_rows * p.d;
  float* ring = p.ring + (size_t)b0 * p.ring_rows * p.d;
  for (size_t i = threadIdx.x; i < nring; i += NT) ring[i] = 0.f;
  for (int i = threadIdx.x; i < DECODE_ROWS * p.xw; i += NT) cur[i] = 0.f;
  if (threadIdx.x < DECODE_ROWS) prev[threadIdx.x] = 0;
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    // AudioEnc on the previous frame (cur) -> q in cur
    run_stack(p, prog, 0, prog.n_enc, false, t, b0, cur, alt, taps, hs,
              stats, xs);
    // [ctx; q] -> alt
    attention(p, t, b0, cur, alt, prev);
    // AudioDec on alt -> logits in alt
    run_stack(p, prog, prog.n_enc, prog.n_dec, true, t, b0, alt, cur, taps,
              hs, stats, xs);
    for (int i = threadIdx.x; i < DECODE_ROWS * p.n_mels; i += NT) {
      const int r = i / p.n_mels, c = i % p.n_mels;
      const float yv = sigmoidf(alt[r * p.xw + c]);
      cur[r * p.xw + c] = yv;  // fed back as the next step's input frame
      if (b0 + r < p.B)
        p.y[((size_t)(b0 + r) * p.T + t) * p.n_mels + c] = yv;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dctts_decode(const float* kt, const float* v, const float* cw,
                            const float* cb, const float* cln,
                            const float* hcw, const float* hcb,
                            const float* hcln, const void* cws,
                            const void* hcws, const int* prog_flat,
                            float* y, float* a, float* ring, int n_enc,
                            int n_dec, int B, int N, int d, int n_mels, int T,
                            int win, float eps, int cmi, int cmo, int mode,
                            int c_base, int hc_base, int c_lo, int hc_lo,
                            void* stream) {
  if (n_enc + n_dec > MAX_LAYERS || win < 1 || win > MAX_WIN || B < 1 ||
      mode < MODE_HIGHEST || mode > MODE_DEFAULT)
    return (int)cudaErrorInvalidValue;
  const bool f32 = mode == MODE_HIGHEST || mode == MODE_HYBRID;
  if ((f32 && (!cw || !hcw)) || (mode != MODE_HIGHEST && (!cws || !hcws)))
    return (int)cudaErrorInvalidValue;
  Program prog;
  prog.n_enc = n_enc;
  prog.n_dec = n_dec;
  int rows = 0;
  for (int i = 0; i < n_enc + n_dec; ++i) {
    const int* f = prog_flat + 6 * i;
    Layer& L = prog.l[i];
    L.kind = f[0];
    L.idx = f[1];
    L.cin = f[2];
    L.cout = f[3];
    L.rate = f[4];
    L.act = f[5];
    L.ring_off = rows;
    if (L.kind == 1) rows += 2 * L.rate + 1;
  }
  for (int i = n_enc + n_dec; i < MAX_LAYERS; ++i) prog.l[i] = Layer{};
  Args p;
  p.kt = kt; p.v = v; p.cw = cw; p.cb = cb; p.cln = cln;
  p.hcw = hcw; p.hcb = hcb; p.hcln = hcln;
  p.cws = static_cast<const bf16_t*>(cws);
  p.hcws = static_cast<const bf16_t*>(hcws);
  p.mode = mode; p.c_base = c_base; p.hc_base = hc_base;
  p.c_lo = c_lo; p.hc_lo = hc_lo;
  p.y = y; p.a = a; p.ring = ring;
  p.B = B; p.N = N; p.d = d; p.n_mels = n_mels; p.T = T; p.win = win;
  p.cmi = cmi; p.cmo = cmo; p.ring_rows = rows;
  p.xw = 2 * d > n_mels ? 2 * d : n_mels;
  p.eps = eps;
  p.scale = (float)(1.0 / sqrt((double)d));
  // the split rows: the widest product's K (3d taps or a C layer's cin)
  const int ldx_max = ((3 * d > cmi ? 3 * d : cmi) + 7) & ~7;
  const size_t smem =
      sizeof(float) * (size_t)DECODE_ROWS * (2 * p.xw + 5 * d + 4) +
      sizeof(bf16_t) * 2 * (size_t)DECODE_ROWS * ldx_max;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + DECODE_ROWS - 1) / DECODE_ROWS;
  decode_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(p, prog);
  return (int)cudaGetLastError();
}
