// Kernel K3: one Griffin-Lim round of stft_method="dft_pallas", on the
// tensor cores.
//
// Replaces dc_tts_tpu/ops/pallas_gl.py:fused_gl_round, whose two Pallas
// calls are _k1_call (inverse rDFT + window + overlap-add + NOLA) and
// _k2_call (re-frame + window + forward rDFT + phase normalisation + |X|).
// The design note is in dc_tts_tpu_torch/ops/gl.py. Three launches a round:
//   dctts_gl_k3a:
//     k3a_gemm       [Xr | Xi] (B*F, 2*n_freq) @ [A ; B] (2*n_freq, n_fft),
//                    x window -> windowed frames (B*F, n_fft), float32
//     gl_ola_kernel  overlap-add x 1/sum(w^2), trimmed and reflect-padded
//                    -> signal (B, n_fft + hop*(F-1))
//   dctts_gl_k3b:
//     k3b_gemm       frames gathered from the signal at j*hop, x window,
//                    @ [C, S] with C and S interleaved as columns (2k, 2k+1),
//                    phase normalised (1e-8 floor) and x mag -> (Xr, Xi)
// Spectra are (B, fp1, n_freq) with rows >= F zero (the JAX package's
// layout); both GEMMs run over the B*F rows that carry data.
// Both GEMMs: bf16 operands, float32 products and sums, one pass (xh@Mh) or
// three (xh@Mh + xh@Ml + xl@Mh). The A tile loader reads float32 and splits
// it into bf16 hi/lo on its way to shared memory (no bf16 copy in device
// memory); B is a constant matrix stored bf16, n rows with k contiguous,
// zero-padded to the tile sizes. mma.sync.m16n8k16 on 128 x 128 x 32 block
// tiles, 8 warps of 64 x 32, one shared-memory stage refilled from
// registers that were loaded during the previous stage's products
// (gemm_block, csrc/bf16_gemm.cuh, shared with X1 in csrc/ct_fwd.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_gemm.cuh"  // gemm_block, Tiles, K3_* tile sizes
#include "gl_ola.cuh"     // gl_ola_kernel, GL_NT

namespace {

// Inverse rDFT of the frames m = b*F + f < M = B*F: A[m, k] = Xr[b, f, k]
// for k < nf, Xi[b, f, k - nf] for k < 2nf, else 0, of spectra (B, fp1,
// nf); B^T = w (n_fft rows padded to K3_BN, kpad columns). Writes
// frames[m, n] = (A @ B)[m, n] * win[n].
template <bool THREE>
__global__ void __launch_bounds__(K3_NT)
k3a_gemm(const float* __restrict__ xr, const float* __restrict__ xi,
         const bf16* __restrict__ whi, const bf16* __restrict__ wlo,
         const float* __restrict__ win, float* __restrict__ frames, int M,
         int F, int fp1, int n_fft, int nf, int kpad) {
  __shared__ Tiles sm;
  const int n0 = blockIdx.x * K3_BN, m0 = blockIdx.y * K3_BM;
  int off[8];  // this thread's A rows: offset into Xr/Xi, -1 past the last
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 16 * i + (threadIdx.x >> 4), b = m / F;
    off[i] = m < M ? (b * fp1 + m - b * F) * nf : -1;
  }
  auto x_at = [&](int o, int k) -> float {
    return k < nf ? xr[o + k] : (k < 2 * nf ? xi[o + k - nf] : 0.f);
  };
  auto fetch = [&](int i, int k) -> float2 {
    const int o = off[i];
    return o < 0 ? make_float2(0.f, 0.f)
                 : make_float2(x_at(o, k), x_at(o, k + 1));
  };
  float acc[4][4][4];
  gemm_block<THREE>(fetch, whi + (size_t)n0 * kpad, wlo + (size_t)n0 * kpad,
                    kpad, kpad, sm, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + wn + nt * 8 + t2;
    if (n >= n_fft) continue;
    const float w0 = win[n], w1 = win[n + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + g + 8 * h;
        if (m < M)
          *reinterpret_cast<float2*>(frames + (size_t)m * n_fft + n) =
              make_float2(acc[mt][nt][2 * h] * w0,
                          acc[mt][nt][2 * h + 1] * w1);
      }
  }
}

// Forward rDFT of the frames m = b*F + j < M = B*F of the signal yp (B,
// ly): A[m, k] = yp[b, j*hop + k] * win[k] for k < n_fft and j*hop + k < ly,
// else 0; B^T = w with row 2k = C[:, k], row 2k+1 = S[:, k], so that each
// thread's accumulator pair is one bin's (Re, Im). Writes X[b, j] = E * mag
// / max(1e-8, |E|) into (B, f2, nf) spectra.
template <bool THREE>
__global__ void __launch_bounds__(K3_NT)
k3b_gemm(const float* __restrict__ yp, const float* __restrict__ mag,
         const bf16* __restrict__ whi, const bf16* __restrict__ wlo,
         const float* __restrict__ win, float* __restrict__ xr,
         float* __restrict__ xi, int M, int F, int f2, int n_fft, int nf,
         int hop, int ly, int kpad) {
  __shared__ Tiles sm;
  const int n0 = blockIdx.x * K3_BN, m0 = blockIdx.y * K3_BM;
  int off[8], lim[8];  // this thread's A rows: frame start, valid samples
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 16 * i + (threadIdx.x >> 4);
    const int b = m / F, j = m - b * F;
    off[i] = b * ly + j * hop;
    lim[i] = m < M ? min(n_fft, ly - j * hop) : 0;
  }
  auto y_at = [&](int i, int k) -> float {
    return k < lim[i] ? yp[off[i] + k] * win[k] : 0.f;
  };
  auto fetch = [&](int i, int k) -> float2 {
    return make_float2(y_at(i, k), y_at(i, k + 1));
  };
  float acc[4][4][4];
  gemm_block<THREE>(fetch, whi + (size_t)n0 * kpad, wlo + (size_t)n0 * kpad,
                    kpad, kpad, sm, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  int row[4][2];  // output row b*f2 + j of the accumulator rows, -1 past M
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mt * 16 + g + 8 * h, b = m / F;
      row[mt][h] = m < M ? b * f2 + m - b * F : -1;
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int k = (n0 + wn + nt * 8 + t2) >> 1;
    if (k >= nf) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[mt][h] < 0) continue;
        const float er = acc[mt][nt][2 * h], ei = acc[mt][nt][2 * h + 1];
        const size_t o = (size_t)row[mt][h] * nf + k;
        const float s = mag[o] / fmaxf(1e-8f, sqrtf(er * er + ei * ei));
        xr[o] = er * s;
        xi[o] = ei * s;
      }
  }
}

}  // namespace

// K3a and the overlap-add: spectrum (Xr, Xi) (B, fp1, nf), rows >= F read
// as zero -> reflect-padded signal yp (B, L_sig + 2*pad). w_hi/w_lo:
// (ceil(n_fft/128)*128, kpad) bf16; frames: (B*F, n_fft) scratch; wsq:
// 1/sum(w^2), at least pad + L_sig samples.
extern "C" int dctts_gl_k3a(const float* xr, const float* xi, const void* w_hi,
                            const void* w_lo, const float* win,
                            const float* wsq, float* frames, float* yp, int B,
                            int n_fft, int nf, int F, int fp1, int hop,
                            int pad, int L_sig, int kpad, int three,
                            void* stream) {
  if (B < 1 || F < 1 || fp1 < F || n_fft % 2 || kpad % K3_BK ||
      kpad < 2 * nf || (long long)B * fp1 * nf >= (1LL << 31) ||
      (long long)B * F * n_fft >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * F, ly = L_sig + 2 * pad;
  const dim3 grid((n_fft + K3_BN - 1) / K3_BN, (M + K3_BM - 1) / K3_BM);
  const bf16* hi = static_cast<const bf16*>(w_hi);
  const bf16* lo = static_cast<const bf16*>(w_lo);
  if (three)
    k3a_gemm<true><<<grid, K3_NT, 0, st>>>(xr, xi, hi, lo, win, frames, M,
                                            F, fp1, n_fft, nf, kpad);
  else
    k3a_gemm<false><<<grid, K3_NT, 0, st>>>(xr, xi, hi, lo, win, frames, M,
                                             F, fp1, n_fft, nf, kpad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gl_ola_kernel<<<dim3((ly + GL_NT - 1) / GL_NT, B), GL_NT, 0, st>>>(
      frames, wsq, yp, n_fft, hop, F, pad, L_sig, ly, 0);
  return (int)cudaGetLastError();
}

// K3b: signal yp (B, ly) and magnitude (B, f2, nf) -> rows < F of the next
// spectrum (Xr, Xi) (B, f2, nf). w_hi/w_lo: (npad, kpad) bf16, npad >= 2*nf
// a multiple of 128, kpad >= n_fft a multiple of 32.
extern "C" int dctts_gl_k3b(const float* yp, const float* mag,
                            const void* w_hi, const void* w_lo,
                            const float* win, float* xr, float* xi, int B,
                            int n_fft, int nf, int F, int f2, int hop,
                            int ly, int kpad, int npad, int three,
                            void* stream) {
  if (B < 1 || F < 1 || f2 < F || kpad % K3_BK || kpad < n_fft || npad % K3_BN ||
      npad < 2 * nf || (long long)B * f2 * nf >= (1LL << 31) ||
      (long long)B * ly >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * F;
  const dim3 grid(npad / K3_BN, (M + K3_BM - 1) / K3_BM);
  const bf16* hi = static_cast<const bf16*>(w_hi);
  const bf16* lo = static_cast<const bf16*>(w_lo);
  if (three)
    k3b_gemm<true><<<grid, K3_NT, 0, st>>>(yp, mag, hi, lo, win, xr, xi, M, F,
                                            f2, n_fft, nf, hop, ly, kpad);
  else
    k3b_gemm<false><<<grid, K3_NT, 0, st>>>(yp, mag, hi, lo, win, xr, xi, M,
                                             F, f2, n_fft, nf, hop, ly, kpad);
  return (int)cudaGetLastError();
}
