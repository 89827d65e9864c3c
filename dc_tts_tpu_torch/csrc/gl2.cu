// Kernel K2: every Griffin-Lim round of a batch of utterances.
//
// Replaces dc_tts_tpu/ops/pallas_gl2.py:gl2_run (body _kernel). The design
// note is in dc_tts_tpu_torch/ops/gl2.py: the state between rounds is the
// windowed frames of the round in device memory; each round is
//   gl_ola_kernel   frames -> OLA * 1/sum(w^2), reflect-mirrored edges
//   gl_frame_kernel signal -> window -> FFT -> impose |X| -> iFFT -> window
// over (frame, utterance). The first launch starts from the magnitude with
// zero phase, the last OLA writes the trimmed waveform. Bound on the H100:
// the FFTs' float32 operations (2 transforms of n_fft points per frame per
// round), then the frames' round trip through device memory.
//
// Transforms: a mixed radix-8 Stockham FFT of the full n_fft-point complex
// spectrum in shared memory (n_fft = 8^a * {1, 2, 4}: four passes at 2048),
// natural order in and out, ping-ponging between two buffers. One radix-8
// butterfly per thread per pass at n_fft = 2048. Few passes keep the
// rounding error low, which matters here: the phase normalisation of
// near-zero bins amplifies it. The inverse transform is the forward one on
// the conjugate (Re ifft(X) = Re fft(conj X) / n). Twiddles exp(-2 pi i k /
// n_fft) come from a float64-computed half-circle table. No fast math.

#include <cuda_runtime.h>

#include "gl_ola.cuh"  // gl_ola_kernel, GL_NT

#define N1 16  // the scrambled magnitude's k1 extent: bin k = k1 + 16*k2

namespace {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// (-i) z
__device__ __forceinline__ float2 mul_mi(float2 z) {
  return make_float2(z.y, -z.x);
}

// exp(-2 pi i k / n) for 0 <= k < n, from the table of k < n/2
__device__ __forceinline__ float2 twiddle(const float2* tw, int k, int half) {
  if (k < half) return tw[k];
  const float2 w = tw[k - half];
  return make_float2(-w.x, -w.y);
}

// In-register forward DFTs of 2, 4 and 8 points.
__device__ __forceinline__ void dft2(float2* v) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2,
                                     float2& v3) {
  const float2 a = cadd(v0, v2), b = csub(v0, v2);
  const float2 c = cadd(v1, v3), d = mul_mi(csub(v1, v3));
  v0 = cadd(a, c);
  v1 = cadd(b, d);
  v2 = csub(a, c);
  v3 = csub(b, d);
}

__device__ __forceinline__ void dft8(float2* v) {
  const float h = 0.70710678118654752f;  // sqrt(1/2)
  float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  // o_k *= exp(-2 pi i k / 8)
  o1 = make_float2(h * (o1.x + o1.y), h * (o1.y - o1.x));
  o2 = mul_mi(o2);
  o3 = make_float2(h * (o3.y - o3.x), -h * (o3.x + o3.y));
  v[0] = cadd(e0, o0);
  v[1] = cadd(e1, o1);
  v[2] = cadd(e2, o2);
  v[3] = cadd(e3, o3);
  v[4] = csub(e0, o0);
  v[5] = csub(e1, o1);
  v[6] = csub(e2, o2);
  v[7] = csub(e3, o3);
}

template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 8) dft8(v);
  else if constexpr (R == 4) dft4(v[0], v[1], v[2], v[3]);
  else dft2(v);
}

// One Stockham pass of radix R after Ns points have been combined:
// butterfly j reads src[j + r*n/R], twiddles, DFTs, and writes
// dst[(j - j%Ns)*R + j%Ns + r*Ns].
template <int R>
__device__ void stockham_pass(const float2* src, float2* dst,
                              const float2* tw, int n, int Ns) {
  const int nb = n / R, step = n / (Ns * R);
  for (int j = threadIdx.x; j < nb; j += GL_NT) {
    const int jm = j & (Ns - 1);
    float2 v[R];
    v[0] = src[j];
#pragma unroll
    for (int r = 1; r < R; ++r)
      v[r] = cmul(src[j + r * nb], twiddle(tw, r * jm * step, n >> 1));
    dft<R>(v);
    const int o = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[o + r * Ns] = v[r];
  }
}

// Forward FFT of a (natural order) using b as the other buffer; returns
// the buffer that holds the result. The caller synchronises before.
__device__ float2* fft(float2* a, float2* b, const float2* tw, int n) {
  int Ns = 1;
  for (; Ns * 8 <= n; Ns *= 8) {
    stockham_pass<8>(a, b, tw, n, Ns);
    __syncthreads();
    float2* t = a; a = b; b = t;
  }
  const int R = n / Ns;
  if (R > 1) {
    if (R == 4) stockham_pass<4>(a, b, tw, n, Ns);
    else stockham_pass<2>(a, b, tw, n, Ns);
    __syncthreads();
    a = b;
  }
  return a;
}

// One block per (frame f, utterance b). first: the spectrum is the
// magnitude with zero phase. Otherwise: the frame of the reflect-padded
// signal yp, windowed, forward FFT, every bin scaled to the magnitude
// (phase with a 1e-8 floor). Then inverse FFT, real part / n, windowed.
__global__ void __launch_bounds__(GL_NT)
gl_frame_kernel(const float* __restrict__ yp, const float* __restrict__ mag,
                const float* __restrict__ win, const float2* __restrict__ twg,
                float* __restrict__ frames, int n, int hop, int F, int F2,
                int ly, int first) {
  extern __shared__ float2 gsm[];
  float2* tw = gsm;          // n/2
  float2* sa = tw + n / 2;   // n
  float2* sb = sa + n;       // n
  const int f = blockIdx.x, b = blockIdx.y, n2 = n / N1;
  for (int i = threadIdx.x; i < n / 2; i += GL_NT) tw[i] = twg[i];
  if (!first) {
    const float* src = yp + (size_t)b * ly + (size_t)f * hop;
    for (int i = threadIdx.x; i < n; i += GL_NT)
      sa[i] = make_float2(src[i] * win[i], 0.f);
  }
  __syncthreads();
  float2* spec = first ? sa : fft(sa, sb, tw, n);
  float2* conj = spec == sa ? sb : sa;
  // i -> (k1, k2) with k2 fastest, so the magnitude reads coalesce; the
  // re-imposed spectrum is stored conjugated for the inverse transform
  const float* mb = mag + (size_t)b * N1 * F2 * n2 + (size_t)f * n2;
  for (int i = threadIdx.x; i < n; i += GL_NT) {
    const int k1 = i / n2, k2 = i % n2, k = k1 + N1 * k2;
    const float m = mb[(size_t)k1 * F2 * n2 + k2];
    float2 x;
    if (first) {
      x = make_float2(m, 0.f);
    } else {
      const float2 e = spec[k];
      const float sc = m / fmaxf(1e-8f, sqrtf(e.x * e.x + e.y * e.y));
      x = make_float2(e.x * sc, -e.y * sc);
    }
    conj[k] = x;
  }
  __syncthreads();
  const float2* out = fft(conj, spec, tw, n);
  const float inv_n = 1.f / (float)n;
  float* dst = frames + ((size_t)b * F + f) * n;
  for (int i = threadIdx.x; i < n; i += GL_NT)
    dst[i] = out[i].x * inv_n * win[i];
}

}  // namespace

extern "C" int dctts_gl2(const float* mag, const float* win, const float* wsq,
                         const float* tw, float* frames, float* yp, float* out,
                         int B, int n_fft, int hop, int F, int F2, int pad,
                         int L_sig, int n_iter, void* stream) {
  if (n_fft < 2 * N1 || (n_fft & (n_fft - 1)) || B < 1 || F < 1 || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ly = n_fft + hop * (F - 1);
  const size_t smem = sizeof(float2) * (size_t)(n_fft / 2 + 2 * n_fft);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gl_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  const dim3 fgrid(F, B), ogrid((ly + GL_NT - 1) / GL_NT, B),
      wgrid((L_sig + GL_NT - 1) / GL_NT, B);
  cudaError_t e;
  gl_frame_kernel<<<fgrid, GL_NT, smem, st>>>(yp, mag, win, tw2, frames,
                                              n_fft, hop, F, F2, ly, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int it = 0; it < n_iter; ++it) {
    gl_ola_kernel<<<ogrid, GL_NT, 0, st>>>(frames, wsq, yp, n_fft, hop, F,
                                           pad, L_sig, ly, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    gl_frame_kernel<<<fgrid, GL_NT, smem, st>>>(yp, mag, win, tw2, frames,
                                                n_fft, hop, F, F2, ly, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  gl_ola_kernel<<<wgrid, GL_NT, 0, st>>>(frames, wsq, out, n_fft, hop, F, pad,
                                         L_sig, L_sig, 1);
  return (int)cudaGetLastError();
}
