// Kernel K2: every Griffin-Lim round of a batch of utterances.
//
// Replaces dc_tts_tpu/ops/pallas_gl2.py:gl2_run (body _kernel). The design
// note is in dc_tts_tpu_torch/ops/gl2.py: the state between rounds is the
// windowed frames of the round in device memory, over the window's nonzero
// span [off, off + len) only; each round is
//   gl_ola_kernel   frames -> OLA * 1/sum(w^2), reflect-mirrored edges
//   gl_frame_kernel signal -> window -> FFT -> impose |X| -> iFFT -> window
// over (frame pair, utterance). The first launch starts from the magnitude
// with zero phase, the last OLA writes the trimmed waveform. Bound on the
// H100: the transforms' operations (one complex transform each way per
// pair of real frames per round), then the frames' round trip through
// device memory and the magnitude read.
//
// The frame kernel is persistent: as many blocks as fit on the card at once
// copy the twiddle tables into shared memory once and then take work items
// from a counter per launch. An item is two real frames f0, f0 + 1 of one
// utterance in one complex transform z = x0 + i x1, split into their two
// spectra after the forward transform and merged with Hermitian halves
// before the inverse.
//
// Transforms: a mixed-radix Stockham FFT of n_fft = 2^a * m points (m odd;
// n_fft % 32 == 0), natural order in and out, planned on the host
// (ops/gl2.py:fft_plan, handed over as the table of fft_passes): radix 8
// passes, then one of 4 or 2, then, for m > 1, one pass of radix m as a
// direct sum; four passes at 2048. Few passes keep the rounding error
// low, which matters here: the phase normalisation of near-zero bins
// amplifies it; so the butterflies compute in float64 (two frames in one
// transform double the error's tail in float32). Each pass keeps a
// butterfly's R points in registers; shared memory (two float32 buffers,
// ping-pong) serves only the exchange between passes, through the XOR
// swizzle xi(), which keeps every pass's stores at most 2-way bank
// conflicted (tests/test_torch_gl2_plan.py). The first pass of the forward
// transform reads the frames from device memory and the last pass of the
// inverse writes them there. Twiddles come from per-pass tables computed in
// float64 on the host (gl2_consts' "fft_tw", float32): pass (R, Ns) with
// Ns > 1 reads exp(-2 pi i r jm / (Ns R)) at [jm][r - 1] (an odd row
// stride: a warp's loads broadcast or fall on distinct banks); the odd pass
// reads exp(-2 pi i k / n) for k < n. The inverse transform is the forward
// one on the conjugate (ifft(W) = conj(fft(conj W)) / n). No fast math.

#include <cuda_runtime.h>

#include "gl_ola.cuh"  // gl_ola_kernel, GL_NT

#define N1 16         // the scrambled magnitude's k1 extent: k = k1 + 16*k2
#define MAX_PASSES 8  // 2^21 * m points at most: shared memory binds first

namespace {

// The passes of one transform (ops/gl2.py:fft_passes): pass p combines R[p]
// points after Ns[p] have been combined; its twiddles start at tw[p].
struct Plan {
  int n, np, n_tw;
  int R[MAX_PASSES], Ns[MAX_PASSES], tw[MAX_PASSES];
};

// Butterfly arithmetic is float64 (double2) in registers; the exchange
// buffers, the twiddle tables and every array in device memory are float32.
__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// (-i) z
__device__ __forceinline__ double2 mul_mi(double2 z) {
  return make_double2(z.y, -z.x);
}
__device__ __forceinline__ double2 wide(float2 v) {
  return make_double2(v.x, v.y);
}
__device__ __forceinline__ float2 narrow(double2 v) {
  return make_float2((float)v.x, (float)v.y);
}

// The exchange buffers' index: i with its low 4 bits (a float2's bank pair)
// XORed by 5 x its 16-element row, a permutation within each row.
__device__ __forceinline__ int xi(int i) { return i ^ ((i >> 4) * 5 & 15); }

// In-register forward DFTs of 2, 4 and 8 points.
__device__ __forceinline__ void dft2(double2* v) {
  const double2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

__device__ __forceinline__ void dft4(double2& v0, double2& v1,
                                     double2& v2, double2& v3) {
  const double2 a = cadd(v0, v2), b = csub(v0, v2);
  const double2 c = cadd(v1, v3), d = mul_mi(csub(v1, v3));
  v0 = cadd(a, c);
  v1 = cadd(b, d);
  v2 = csub(a, c);
  v3 = csub(b, d);
}

__device__ __forceinline__ void dft8(double2* v) {
  const double h = 0.70710678118654752440;  // sqrt(1/2)
  double2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  double2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  // o_k *= exp(-2 pi i k / 8)
  o1 = make_double2(h * (o1.x + o1.y), h * (o1.y - o1.x));
  o2 = mul_mi(o2);
  o3 = make_double2(h * (o3.y - o3.x), -h * (o3.x + o3.y));
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
__device__ __forceinline__ void dft(double2* v) {
  if constexpr (R == 8) dft8(v);
  else if constexpr (R == 4) dft4(v[0], v[1], v[2], v[3]);
  else dft2(v);
}

// One Stockham pass of radix R (a power of two) after Ns points have been
// combined: butterfly j loads load(j + r*n/R), twiddles by tw[jm][r - 1]
// (jm = j % Ns), DFTs in registers, and stores store((j - jm)*R + jm +
// r*Ns, value).
template <int R, class Load, class Store>
__device__ __forceinline__ void pow2_pass(int n, int Ns, const float2* tw,
                                          Load load, Store store) {
  const int nb = n / R;
  for (int j = threadIdx.x; j < nb; j += GL_NT) {
    const int jm = j & (Ns - 1);
    double2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = wide(load(j + r * nb));
    if (Ns > 1) {
      const float2* t = tw + jm * (R - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], wide(t[r - 1]));
    }
    dft<R>(v);
    const int o = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) store(o + r * Ns, narrow(v[r]));
  }
}

// The last pass, of odd radix m after Ns = n/m points (a power of two):
// output k = sum_q load(k % Ns + q*Ns) exp(-2 pi i q k / n), a direct sum
// with tw[k'] = exp(-2 pi i k' / n).
template <class Load, class Store>
__device__ __forceinline__ void odd_pass(int n, int m, int Ns,
                                         const float2* tw, Load load,
                                         Store store) {
  for (int k = threadIdx.x; k < n; k += GL_NT) {
    const int j = k & (Ns - 1);
    double2 acc = wide(load(j));
    int e = 0;  // q*k mod n
    for (int q = 1; q < m; ++q) {
      e += k;
      if (e >= n) e -= n;
      acc = cadd(acc, cmul(wide(load(j + q * Ns)), wide(tw[e])));
    }
    store(k, narrow(acc));
  }
}

template <class Load, class Store>
__device__ __forceinline__ void any_pass(const Plan& pl, int p,
                                         const float2* tw, Load load,
                                         Store store) {
  const int R = pl.R[p], Ns = pl.Ns[p];
  const float2* t = tw + pl.tw[p];
  if (R == 8) pow2_pass<8>(pl.n, Ns, t, load, store);
  else if (R == 4) pow2_pass<4>(pl.n, Ns, t, load, store);
  else if (R == 2) pow2_pass<2>(pl.n, Ns, t, load, store);
  else odd_pass(pl.n, R, Ns, t, load, store);
}

// Forward FFT. The first pass reads load0(i) (natural order) and writes a,
// the passes between exchange through a and b (barrier after each), the
// last hands output i to store(free, i, v), free the buffer it does not
// read. Returns that buffer. No barrier after the last pass.
template <class Load, class Store>
__device__ float2* fft(const Plan& pl, const float2* tw, float2* a,
                       float2* b, Load load0, Store store) {
  any_pass(pl, 0, tw, load0, [a](int i, float2 v) { a[xi(i)] = v; });
  __syncthreads();
  float2 *src = a, *dst = b;
  for (int p = 1; p < pl.np - 1; ++p) {
    any_pass(pl, p, tw, [src](int i) { return src[xi(i)]; },
             [dst](int i, float2 v) { dst[xi(i)] = v; });
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
  }
  any_pass(pl, pl.np - 1, tw, [src](int i) { return src[xi(i)]; },
           [dst, &store](int i, float2 v) { store(dst, i, v); });
  return dst;
}

// A persistent grid: each block copies the twiddle tables into its shared
// memory once, then takes work items w = (frame pair p, utterance b), p
// fastest, from the launch's counter until none is left (so blocks that
// finish early take more, as the hardware's block scheduler would). A pair
// is the real frames f0 = 2p and f1 = 2p + 1 (a zero frame when f1 = F) in
// one complex transform, z = x0 + i x1.
// first: the spectra are the magnitudes with zero phase. Otherwise: the
// pair's frames of the reflect-padded signal yp, windowed, forward FFT,
// split into the two spectra, each bin k <= n/2 scaled to its magnitude
// (phase with a 1e-8 floor), merged with Hermitian halves. Then inverse
// FFT: the frames are its real and imaginary parts / n, windowed.
__global__ void __launch_bounds__(GL_NT)
gl_frame_kernel(const float* __restrict__ yp, const float* __restrict__ mag,
                const float* __restrict__ win, const float2* __restrict__ twg,
                float* __restrict__ frames, int* __restrict__ next,
                const Plan pl, int off, int len, int hop, int F, int F2,
                int ly, int n_items, int first) {
  extern __shared__ float2 gsm[];
  __shared__ int s_w;
  const int n = pl.n, h2 = n / (2 * N1), pairs = (F + 1) / 2;
  float2* tw = gsm;           // pl.n_tw
  float2* sa = tw + pl.n_tw;  // n
  float2* sb = sa + n;        // n
  for (int i = threadIdx.x; i < pl.n_tw; i += GL_NT) tw[i] = twg[i];
  const float inv_n = 1.f / (float)n;
  for (;;) {
    __syncthreads();  // the twiddles, or the last item's reads, are done
    if (threadIdx.x == 0) s_w = atomicAdd(next, 1);
    __syncthreads();
    const int w = s_w;
    if (w >= n_items) break;
    const int f0 = 2 * (w % pairs), b = w / pairs;
    const bool two = f0 + 1 < F;
    float2* spec = nullptr;  // the forward spectrum Z of the pair
    float2* conj = sa;       // the merged spectrum W, conjugated
    if (!first) {
      // the window is zero outside [off, off + len): read the span only
      const float* x0 = yp + (size_t)b * ly + (size_t)f0 * hop;
      const float* x1 = x0 + hop;
      spec = fft(
          pl, tw, sa, sb,
          [x0, x1, win, two, off, len](int i) {
            if ((unsigned)(i - off) >= (unsigned)len)
              return make_float2(0.f, 0.f);
            return make_float2(x0[i] * win[i], two ? x1[i] * win[i] : 0.f);
          },
          [](float2* d, int i, float2 v) { d[xi(i)] = v; });
      conj = spec == sa ? sb : sa;
      __syncthreads();
    }
    // bins k < n/2 as (k1, k2) = (k % 16, k / 16), k2 fastest, so the
    // magnitude reads coalesce; i = n/2 is the Nyquist bin
    const size_t row = (size_t)F2 * 2 * h2;  // one k1 of the layout
    const float* m0 = mag + (size_t)b * N1 * row + (size_t)f0 * 2 * h2;
    for (int i = threadIdx.x; i <= n / 2; i += GL_NT) {
      const int k1 = i < n / 2 ? i / h2 : 0, k2 = i < n / 2 ? i % h2 : h2;
      const int k = k1 + N1 * k2;
      const float g0 = m0[k1 * row + k2];
      const float g1 = two ? m0[k1 * row + 2 * h2 + k2] : 0.f;
      float2 x, y;  // the two re-imposed spectra at bin k
      if (first) {
        x = make_float2(g0, 0.f);
        y = make_float2(g1, 0.f);
      } else {
        const float2 a = spec[xi(k)], c = spec[xi(k ? n - k : 0)];
        // X = (Z[k] + conj Z[n-k]) / 2, Y = (Z[k] - conj Z[n-k]) / 2i
        x = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
        y = make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x));
        const float sx = g0 / fmaxf(1e-8f, sqrtf(x.x * x.x + x.y * x.y));
        const float sy = g1 / fmaxf(1e-8f, sqrtf(y.x * y.x + y.y * y.y));
        x = make_float2(x.x * sx, x.y * sx);
        y = make_float2(y.x * sy, y.y * sy);
      }
      // conj W[k] = conj(X + iY), conj W[n-k] = conj(conj X + i conj Y)
      conj[xi(k)] = make_float2(x.x - y.y, -(x.y + y.x));
      if (k != 0 && 2 * k != n)
        conj[xi(n - k)] = make_float2(x.x + y.y, x.y - y.x);
    }
    __syncthreads();
    // frames hold the window's span only: sample i at i - off
    float* d0 = frames + ((size_t)b * F + f0) * len;
    float* d1 = d0 + len;
    fft(pl, tw, conj == sa ? sb : sa, conj,
        [conj](int i) { return conj[xi(i)]; },
        [d0, d1, win, inv_n, two, off, len](float2*, int i, float2 v) {
          if ((unsigned)(i - off) >= (unsigned)len) return;
          // w = ifft(W) = conj(fft(conj W)) / n
          d0[i - off] = v.x * inv_n * win[i];
          if (two) d1[i - off] = -v.y * inv_n * win[i];
        });
  }
}

}  // namespace

// The transform's plan from ops/gl2.py:fft_passes, (R, Ns, twiddle offset)
// a pass; false unless it is one the kernel runs: radix 2, 4, 8 or odd,
// each pass after the points the ones before it combined, n in all, every
// table inside the n_tw twiddles.
static bool take_plan(int n, const int* passes, int np, int n_tw, Plan* pl) {
  if (n < 1 || np < 1 || np > MAX_PASSES || n_tw < 0) return false;
  int Ns = 1;
  for (int p = 0; p < np; ++p) {
    const int R = passes[3 * p], tw = passes[3 * p + 2];
    const bool odd = R % 2 != 0;
    if (passes[3 * p + 1] != Ns || R < 2 || !(odd || R == 2 || R == 4 ||
                                              R == 8) ||
        Ns > n / R || tw < 0 ||
        tw + (odd ? n : Ns > 1 ? Ns * (R - 1) : 0) > n_tw)
      return false;
    pl->R[p] = R;
    pl->Ns[p] = Ns;
    pl->tw[p] = tw;
    Ns *= R;
  }
  pl->n = n;
  pl->np = np;
  pl->n_tw = n_tw;
  return Ns == n;
}

// The frame kernel's dynamic shared memory and persistent grid: as many
// blocks as fit on every SM at once (the occupancy query), times the SMs.
static cudaError_t frame_launch(const Plan& pl, size_t* smem, int* blocks) {
  *smem = sizeof(float2) * (size_t)(pl.n_tw + 2 * pl.n);
  cudaError_t e;
  if (*smem > 48 * 1024) {
    e = cudaFuncSetAttribute(gl_frame_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e != cudaSuccess) return e;
  }
  int dev, sms, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gl_frame_kernel,
                                                    GL_NT, *smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return cudaSuccess;
}

// Every round of Griffin-Lim. passes: the host's (n_passes, 3) plan
// (ops/gl2.py:fft_passes); tw: its n_tw twiddles; *grid: the frame
// kernel's block count (host memory, may be null).
extern "C" int dctts_gl2(const float* mag, const float* win, const float* wsq,
                         const float* tw, float* frames, float* yp, float* out,
                         int* counters, const int* passes, int n_passes,
                         int B, int n_fft, int hop, int F, int F2, int pad,
                         int L_sig, int n_iter, int n_tw, int off, int len,
                         int* grid, void* stream) {
  Plan pl;
  if (!take_plan(n_fft, passes, n_passes, n_tw, &pl) || B < 1 || F < 1 ||
      n_iter < 0 || off < 0 || len < 1 || off + len > n_fft)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ly = n_fft + hop * (F - 1), n_items = (F + 1) / 2 * B;
  size_t smem;
  int blocks;
  cudaError_t e = frame_launch(pl, &smem, &blocks);
  if (e != cudaSuccess) return (int)e;
  if (grid) *grid = blocks < n_items ? blocks : n_items;
  // one work counter per frame-kernel launch
  e = cudaMemsetAsync(counters, 0, sizeof(int) * (size_t)(n_iter + 1), st);
  if (e != cudaSuccess) return (int)e;
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  const dim3 fgrid(blocks < n_items ? blocks : n_items),
      ogrid((ly + GL_NT - 1) / GL_NT, B),
      wgrid((L_sig + GL_NT - 1) / GL_NT, B);
  gl_frame_kernel<<<fgrid, GL_NT, smem, st>>>(yp, mag, win, tw2, frames,
                                              counters, pl, off, len, hop, F,
                                              F2, ly, n_items, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int it = 0; it < n_iter; ++it) {
    gl_ola_kernel<<<ogrid, GL_NT, 0, st>>>(frames, wsq, yp, off, len, hop, F,
                                           pad, L_sig, ly, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    gl_frame_kernel<<<fgrid, GL_NT, smem, st>>>(yp, mag, win, tw2, frames,
                                                counters + it + 1, pl, off,
                                                len, hop, F, F2, ly, n_items,
                                                0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  gl_ola_kernel<<<wgrid, GL_NT, 0, st>>>(frames, wsq, out, off, len, hop, F,
                                         pad, L_sig, L_sig, 1);
  return (int)cudaGetLastError();
}
