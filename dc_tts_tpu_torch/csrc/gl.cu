// Kernel K3: one Griffin-Lim round of stft_method="dft_pallas", on the
// tensor cores.
//
// Replaces dc_tts_tpu/ops/pallas_gl.py:fused_gl_round, whose two Pallas
// calls are _k1_call (inverse rDFT + window + overlap-add + NOLA) and
// _k2_call (re-frame + window + forward rDFT + phase normalisation + |X|).
// The design note is in dc_tts_tpu_torch/ops/gl.py. Launches a round:
//   dctts_gl_k3a:
//     k3a_prep       [Xr | Xi] rows of the B*F frames -> bf16 hi (and lo),
//                    (B*F, kpad), zero from 2*n_freq on
//     wg::gemm<K3aOp>  A (B*F, kpad) @ [A ; B] (kpad, n_fft) on the bf16
//                    wgmma core (csrc/bf16_wgmma.cuh), x window -> windowed
//                    frames (B*F, n_fft), float32; the N tiles outside the
//                    window's span only write zeros
//     gl_ola_kernel  overlap-add x 1/sum(w^2), trimmed and reflect-padded
//                    -> signal (B, n_fft + hop*(F-1))
//   dctts_gl_k3b:
//     k3b_prep       frames of the signal at j*hop, x window, over the
//                    k-tiles of the window's span -> bf16 hi (and lo)
//     wg::gemm<K3bOp>  those @ [C, S] (C and S interleaved as columns 2k,
//                    2k+1) over the span's k-tiles, phase normalised (1e-8
//                    floor) and x mag -> (Xr, Xi)
// Spectra are (B, fp1, n_freq) with rows >= F zero (the JAX package's
// layout); both GEMMs run over the B*F rows that carry data.
// Both GEMMs: bf16 operands, float32 sums, one pass (xh@Mh) or three (xh@Mh
// + xh@Ml + xl@Mh). The operands' rounding points are the JAX kernels':
// K3a rounds the spectrum, K3b the float32 product yp*win. B is a constant
// matrix stored bf16, n rows with k contiguous (K-major), zero-padded to the
// tiles.
// Why the A operands go through a prep pass: K3a's rows are n_freq = 1025
// floats and K3b's frames start at j*hop = 275 floats, neither 16-byte
// aligned, so neither 16-byte cp.async nor a TMA box can read them. The
// prep pass writes aligned bf16 rows (K3b's only over the span) at device
// bandwidth, and the GEMMs then share K4's 16-byte cp.async loader: the
// alternative, a producer that loads float32 four bytes at a time and
// rounds in registers, puts 8x the load instructions of a 16-byte copy on
// the producer warpgroup at every k-tile. The prep passes take 0.08 and
// 0.035 ms of K3a's 0.39 and K3b's 0.37 ms a single-pass round at
// base_config(), B = 20 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// phase K3, torch.profiler).
// The window is exactly zero outside its win_length samples (nonzero at
// [474, 1575) of 2048 at base_config()), so K3a computes only the N tiles
// that meet the span (the others are acc * 0 = 0) and K3b only the k-tiles
// that meet it (its operands are 0 elsewhere): ops/gl.py:window_span. The
// result is unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"  // wg::gemm, wg::launch, bf16
#include "gl_ola.cuh"      // gl_ola_kernel, GL_NT

namespace {

constexpr int PREP_NT = 256;  // threads of a prep block, 4 columns each

// v rounded to bf16 hi into a[at..at+3], and with THREE lo = bf16(v - hi)
// part_stride elements further on (8-byte stores: at % 4 == 0)
template <bool THREE>
__device__ __forceinline__ void store_split4(bf16* a, size_t at,
                                             size_t part_stride,
                                             const float (&v)[4]) {
  __nv_bfloat162 h[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    l[i] = __floats2bfloat162_rn(v[2 * i] - __low2float(h[i]),
                                 v[2 * i + 1] - __high2float(h[i]));
  }
  *reinterpret_cast<uint2*>(a + at) = *reinterpret_cast<const uint2*>(h);
  if (THREE)
    *reinterpret_cast<uint2*>(a + part_stride + at) =
        *reinterpret_cast<const uint2*>(l);
}

// K3a's A: row m = b*F + f of [Xr | Xi] (B, fp1, nf), zero for k >= 2nf.
// Block (m, 4*PREP_NT columns).
template <bool THREE>
__global__ void __launch_bounds__(PREP_NT)
k3a_prep(const float* __restrict__ xr, const float* __restrict__ xi,
         bf16* __restrict__ a, int M, int F, int fp1, int nf, int kpad) {
  const int m = blockIdx.x, k0 = 4 * (blockIdx.y * PREP_NT + threadIdx.x);
  if (k0 >= kpad) return;  // kpad % 4 == 0
  const int b = m / F;
  const size_t o = ((size_t)b * fp1 + m - b * F) * nf;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + i;
    v[i] = k < nf ? xr[o + k] : (k < 2 * nf ? xi[o + k - nf] : 0.f);
  }
  store_split4<THREE>(a, (size_t)m * kpad + k0, (size_t)M * kpad, v);
}

// K3b's A: row m = b*F + j, column k - k0 for k in [k0, k0 + kw): yp[b, j*hop
// + k] * win[k] for k < n_fft and j*hop + k < ly, else 0
template <bool THREE>
__global__ void __launch_bounds__(PREP_NT)
k3b_prep(const float* __restrict__ yp, const float* __restrict__ win,
         bf16* __restrict__ a, int M, int F, int n_fft, int hop, int ly,
         int k0, int kw) {
  const int m = blockIdx.x, c0 = 4 * (blockIdx.y * PREP_NT + threadIdx.x);
  if (c0 >= kw) return;  // kw % 4 == 0
  const int b = m / F, j = m - b * F;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + c0 + i;
    v[i] = (k < n_fft && j * hop + k < ly)
               ? yp[(size_t)b * ly + j * hop + k] * win[k]
               : 0.f;
  }
  store_split4<THREE>(a, (size_t)m * kw + c0, (size_t)M * kw, v);
}

// The operands of both GEMMs: A (PARTS, M, lda) bf16 rows, B^T (n rows of
// ldw, columns from kb) hi and lo, both K-major.
struct K3Operands {
  const bf16* A;
  const bf16* whi;
  const bf16* wlo;
  int M, lda, ldw, kb, nk;
};

// loader and tile shared by K3a and K3b
template <bool THREE>
struct K3Base {
  static constexpr int PARTS = THREE ? 2 : 1;
  static constexpr bool A_MN = false, B_MN = false;
  struct Shared {};
  int m0, n0, nk;
  bool skip = false;

  __device__ void init_shared(Shared&, int) {}
  __device__ void producer_init(const Shared&, int) {}

  // 128 rows x 8 chunks of A and of B^T; A rows >= M are zero fill
  __device__ void load_tiles(const K3Operands& o, int kt, uint32_t a,
                             uint32_t b) const {
    const int pt = threadIdx.x - 256, col = pt & 7, row0 = pt >> 3;
    const int k = kt * wg::BK + 8 * col;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + 16 * i, m = m0 + r;
      const bool ok = m < o.M;
      const size_t off = ok ? (size_t)m * o.lda + k : 0;
      const size_t wof = (size_t)(n0 + r) * o.ldw + o.kb + k;
      sm90::cp_async16(a + wg::kmaj(r, col), o.A + off, ok ? 16 : 0);
      sm90::cp_async16(b + wg::kmaj(r, col), o.whi + wof, 16);
      if (THREE) {
        sm90::cp_async16(a + wg::TILE_BYTES + wg::kmaj(r, col),
                         o.A + (size_t)o.M * o.lda + off, ok ? 16 : 0);
        sm90::cp_async16(b + wg::TILE_BYTES + wg::kmaj(r, col), o.wlo + wof,
                         16);
      }
    }
  }
};

// K3a: frames[m, n] = (A @ B)[m, n] * win[n], n < n_fft; the N tiles
// outside [nt0, nt1) are zero.
struct K3aArgs {
  K3Operands o;
  const float* win;
  float* frames;
  int n_fft, nt0, nt1;
};

template <bool THREE>
struct K3aOp : K3Base<THREE> {
  typedef K3aArgs Args;
  typedef typename K3Base<THREE>::Shared Shared;
  const Args p;
  __device__ K3aOp(const Args& a) : p(a) {
    this->m0 = (int)blockIdx.y * wg::BM;
    this->n0 = (int)blockIdx.x * wg::BN;
    this->nk = p.o.nk;
    this->skip = (int)blockIdx.x < p.nt0 || (int)blockIdx.x >= p.nt1;
  }

  __device__ void zero_tile(int tid) const {
    const int cols = min(wg::BN, p.n_fft - this->n0) / 2;  // float2s a row
    for (int i = tid; i < wg::BM * cols; i += wg::THREADS) {
      const int m = this->m0 + i / cols, n = this->n0 + 2 * (i % cols);
      if (m < p.o.M)
        *reinterpret_cast<float2*>(p.frames + (size_t)m * p.n_fft + n) =
            make_float2(0.f, 0.f);
    }
  }

  __device__ void load(const Shared&, int kt, uint32_t a, uint32_t b) const {
    this->load_tiles(p.o, kt, a, b);
  }

  __device__ void epilogue(const float (&sum)[64], int r, int t) const {
    float2 w[16];  // loaded before the first store (see K3bOp::epilogue)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = this->n0 + 8 * i + 2 * t;
      w[i] = n < p.n_fft ? *reinterpret_cast<const float2*>(p.win + n)
                         : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = this->n0 + 8 * i + 2 * t;
      if (n >= p.n_fft) continue;  // n_fft is even
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = this->m0 + r + 8 * h;
        if (m < p.o.M)
          *reinterpret_cast<float2*>(p.frames + (size_t)m * p.n_fft + n) =
              make_float2(sum[4 * i + 2 * h] * w[i].x,
                          sum[4 * i + 2 * h + 1] * w[i].y);
      }
    }
  }
};

// K3b: E = A @ [C, S] with columns (2k, 2k+1) one bin's (Re, Im); writes
// X[b, j] = E * mag / max(1e-8, |E|) into (B, f2, nf) spectra.
struct K3bArgs {
  K3Operands o;
  const float* mag;
  float* xr;
  float* xi;
  int F, f2, nf;
};

template <bool THREE>
struct K3bOp : K3Base<THREE> {
  typedef K3bArgs Args;
  typedef typename K3Base<THREE>::Shared Shared;
  const Args p;
  __device__ K3bOp(const Args& a) : p(a) {
    this->m0 = (int)blockIdx.y * wg::BM;
    this->n0 = (int)blockIdx.x * wg::BN;
    this->nk = p.o.nk;
  }

  __device__ void zero_tile(int) const {}

  __device__ void load(const Shared&, int kt, uint32_t a, uint32_t b) const {
    this->load_tiles(p.o, kt, a, b);
  }

  // every mag value of the tile is loaded before the first store: loads
  // after stores to memory they might alias would each wait their turn
  __device__ void epilogue(const float (&sum)[64], int r, int t) const {
    size_t row[2];
    float mg[2][16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = this->m0 + r + 8 * h, b = m / p.F;
      row[h] = (size_t)b * p.f2 + m - b * p.F;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int k = (this->n0 + 8 * i + 2 * t) >> 1;
        mg[h][i] = m < p.o.M && k < p.nf ? p.mag[row[h] * p.nf + k] : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (this->m0 + r + 8 * h >= p.o.M) continue;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int k = (this->n0 + 8 * i + 2 * t) >> 1;
        if (k >= p.nf) continue;
        const float er = sum[4 * i + 2 * h], ei = sum[4 * i + 2 * h + 1];
        const size_t o = row[h] * p.nf + k;
        const float s = mg[h][i] / fmaxf(1e-8f, sqrtf(er * er + ei * ei));
        p.xr[o] = er * s;
        p.xi[o] = ei * s;
      }
    }
  }
};

template <template <bool> class Op, class Args>
cudaError_t launch_k3(const Args& a, dim3 grid, int three, cudaStream_t st) {
  return three ? wg::launch<Op<true>>(a, grid, st)
               : wg::launch<Op<false>>(a, grid, st);
}

}  // namespace

// K3a and the overlap-add: spectrum (Xr, Xi) (B, fp1, nf), rows >= F read
// as zero -> reflect-padded signal yp (B, L_sig + 2*pad). w_hi/w_lo:
// (ceil(n_fft/128)*128, kpad) bf16, kpad >= 2*nf a multiple of 64; a:
// (1 + three, B*F, kpad) bf16 scratch; frames: (B*F, n_fft) scratch; wsq:
// 1/sum(w^2), at least pad + L_sig samples. The N tiles of 128 samples
// [nt0, nt1) cover the window's nonzero samples.
extern "C" int dctts_gl_k3a(const float* xr, const float* xi, const void* w_hi,
                            const void* w_lo, const float* win,
                            const float* wsq, float* frames, float* yp,
                            void* a, int B, int n_fft, int nf, int F,
                            int fp1, int hop, int pad, int L_sig, int kpad,
                            int nt0, int nt1, int three, void* stream) {
  const int n_tiles = (n_fft + wg::BN - 1) / wg::BN;
  if (B < 1 || F < 1 || fp1 < F || n_fft % 2 || kpad % wg::BK ||
      kpad < 2 * nf || nt0 < 0 || nt1 > n_tiles || nt0 >= nt1 ||
      (long long)B * fp1 * nf >= (1LL << 31) ||
      (long long)B * F * n_fft >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * F, ly = L_sig + 2 * pad;
  bf16* ab = static_cast<bf16*>(a);
  const dim3 pg(M, (kpad + 4 * PREP_NT - 1) / (4 * PREP_NT));
  if (three)
    k3a_prep<true><<<pg, PREP_NT, 0, st>>>(xr, xi, ab, M, F, fp1, nf, kpad);
  else
    k3a_prep<false><<<pg, PREP_NT, 0, st>>>(xr, xi, ab, M, F, fp1, nf, kpad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const K3aArgs args{{ab, static_cast<const bf16*>(w_hi),
                      static_cast<const bf16*>(w_lo), M, kpad, kpad, 0,
                      kpad / wg::BK},
                     win, frames, n_fft, nt0, nt1};
  e = launch_k3<K3aOp>(args, dim3(n_tiles, (M + wg::BM - 1) / wg::BM), three,
                       st);
  if (e != cudaSuccess) return (int)e;
  gl_ola_kernel<<<dim3((ly + GL_NT - 1) / GL_NT, B), GL_NT, 0, st>>>(
      frames, wsq, yp, 0, n_fft, hop, F, pad, L_sig, ly, 0);
  return (int)cudaGetLastError();
}

// K3b: signal yp (B, ly) and magnitude (B, f2, nf) -> rows < F of the next
// spectrum (Xr, Xi) (B, f2, nf). w_hi/w_lo: (npad, kpad) bf16, npad >= 2*nf
// a multiple of 128, kpad >= n_fft a multiple of 64; the k-tiles of 64
// samples [kt0, kt1) cover the window's nonzero samples; a: (1 + three,
// B*F, (kt1 - kt0)*64) bf16 scratch.
extern "C" int dctts_gl_k3b(const float* yp, const float* mag,
                            const void* w_hi, const void* w_lo,
                            const float* win, float* xr, float* xi, void* a,
                            int B, int n_fft, int nf, int F, int f2, int hop,
                            int ly, int kpad, int npad, int kt0, int kt1,
                            int three, void* stream) {
  const int kw = (kt1 - kt0) * wg::BK;
  if (B < 1 || F < 1 || f2 < F || kpad % wg::BK || kpad < n_fft ||
      npad % wg::BN || npad < 2 * nf || kt0 < 0 || kt0 >= kt1 ||
      kt1 * wg::BK > kpad || (long long)B * f2 * nf >= (1LL << 31) ||
      (long long)B * ly >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * F;
  bf16* ab = static_cast<bf16*>(a);
  const dim3 pg(M, (kw + 4 * PREP_NT - 1) / (4 * PREP_NT));
  const int k0 = kt0 * wg::BK;
  if (three)
    k3b_prep<true><<<pg, PREP_NT, 0, st>>>(yp, win, ab, M, F, n_fft, hop, ly,
                                           k0, kw);
  else
    k3b_prep<false><<<pg, PREP_NT, 0, st>>>(yp, win, ab, M, F, n_fft, hop,
                                            ly, k0, kw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const K3bArgs args{{ab, static_cast<const bf16*>(w_hi),
                      static_cast<const bf16*>(w_lo), M, kw, kpad, k0,
                      kt1 - kt0},
                     mag, xr, xi, F, f2, nf};
  return (int)launch_k3<K3bOp>(
      args, dim3(npad / wg::BN, (M + wg::BM - 1) / wg::BM), three, st);
}
