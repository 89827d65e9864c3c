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
// take work items from a counter per launch, one item a block. An item is
// two real frames f0, f0 + 1 of one utterance in one complex transform z =
// x0 + i x1, split into their two spectra after the forward transform and
// merged with Hermitian halves before the inverse.
//
// Transforms: a mixed-radix Stockham FFT of n_fft = 2^a * m points (m odd;
// n_fft % 32 == 0, n_fft <= 16 * NT_MAX), natural order in and out, planned
// on the host (ops/gl2.py:fft_plan, handed over as the table of
// fft_passes): radix 16 passes, then one of 8, 4 or 2, then, for m > 1,
// one pass of radix m; three passes at 2048 (16, 16, 8). The butterflies
// compute in float64, no fast math: the phase normalisation of near-zero
// bins amplifies rounding, and two frames in one transform double the
// error's tail in float32. A block carries an item with n/16 threads
// (whole warps; 128 at 2048), each holding 16 points of a pass in
// registers: one radix-16 butterfly or two of radix 8 (fast_pass), whose
// outputs it narrows to float32 before the exchange; a pass of 4, 2 or odd
// radix is a direct sum with rolled loops (sum_pass), kept small beside
// them. Shared memory holds one float32 exchange buffer of n points (16 KB
// at 2048), used in place: a pass loads its points, computes, meets a block
// barrier and stores, through the XOR swizzle xi(), which keeps every
// pass's loads and stores at most 2-way bank conflicted at power-of-two n
// (tests/test_torch_gl2_plan.py). The first pass of the forward transform
// reads the frames from device memory and the last pass of the inverse
// writes them there. Twiddles come from per-pass float64 tables computed
// on the host (gl2_consts' "fft_tw", double2 in device memory), read
// through L1 (__ldg): a pass (R, Ns) of 16 or 8 with Ns > 1 reads w^b, w
// = exp(-2 pi i jm / (Ns R)), at row log2(b) for b = 1, 2, 4 (and 8) (jm
// fastest: a warp's loads fall on consecutive addresses or broadcast) and
// forms the other powers as products; a direct-sum pass reads exp(-2 pi i
// k / n) for k < n. The inverse transform is the forward one on the
// conjugate (ifft(W) = conj(fft(conj W)) / n).

#include <cuda_runtime.h>

#include "gl_ola.cuh"  // gl_ola_kernel, GL_NT

#define N1 16         // the scrambled magnitude's k1 extent: k = k1 + 16*k2
#define MAX_PASSES 8  // n_fft <= 16 * NT_MAX takes five at most
#define P_THREAD 16   // points a thread holds in a pass
#define NT_MAX 512    // threads an item at most: n_fft <= 16 * NT_MAX

namespace {

// The passes of one transform (ops/gl2.py:fft_passes): pass p combines R[p]
// points after Ns[p] have been combined; its twiddles start at tw[p].
struct Plan {
  int n, np;
  int R[MAX_PASSES], Ns[MAX_PASSES], tw[MAX_PASSES];
};

// Butterfly arithmetic and the twiddle tables are float64 (double2); the
// exchange buffer and every other array in device memory are float32.
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

// The exchange buffer's index: i with its low 4 bits (a float2's bank pair)
// XORed by 5 x its 16-element row, a permutation within each row.
__device__ __forceinline__ int xi(int i) { return i ^ ((i >> 4) * 5 & 15); }

// In-register forward DFTs of 4, 8 and 16 points.
__device__ __forceinline__ void dft4(double2& v0, double2& v1,
                                     double2& v2, double2& v3) {
  const double2 a = cadd(v0, v2), b = csub(v0, v2);
  const double2 c = cadd(v1, v3), d = mul_mi(csub(v1, v3));
  v0 = cadd(a, c);
  v1 = cadd(b, d);
  v2 = csub(a, c);
  v3 = csub(b, d);
}

constexpr double kH = 0.70710678118654752440;   // sqrt(1/2)
constexpr double kC = 0.92387953251128675613;   // cos(pi/8)
constexpr double kS = 0.38268343236508977173;   // sin(pi/8)

// z exp(-2 pi i k / 16) for k = 1, 2, 3, 6 and 9
__device__ __forceinline__ double2 w16_1(double2 z) {
  return make_double2(kC * z.x + kS * z.y, kC * z.y - kS * z.x);
}
__device__ __forceinline__ double2 w16_2(double2 z) {
  return make_double2(kH * (z.x + z.y), kH * (z.y - z.x));
}
__device__ __forceinline__ double2 w16_3(double2 z) {
  return make_double2(kS * z.x + kC * z.y, kS * z.y - kC * z.x);
}
__device__ __forceinline__ double2 w16_6(double2 z) {
  return make_double2(kH * (z.y - z.x), -kH * (z.x + z.y));
}
__device__ __forceinline__ double2 w16_9(double2 z) {
  return make_double2(-kC * z.x - kS * z.y, kS * z.x - kC * z.y);
}

__device__ __forceinline__ void dft8(double2* v) {
  double2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  double2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  // o_k *= exp(-2 pi i k / 8)
  o1 = w16_2(o1);
  o2 = mul_mi(o2);
  o3 = w16_6(o3);
  v[0] = cadd(e0, o0);
  v[1] = cadd(e1, o1);
  v[2] = cadd(e2, o2);
  v[3] = cadd(e3, o3);
  v[4] = csub(e0, o0);
  v[5] = csub(e1, o1);
  v[6] = csub(e2, o2);
  v[7] = csub(e3, o3);
}

// 16 points as 4 x 4: point 4 n1 + n2, bin k1 + 4 k2. DFTs of 4 over n1,
// twiddles exp(-2 pi i n2 k1 / 16), DFTs of 4 over n2.
__device__ __forceinline__ void dft16(double2* v) {
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) dft4(v[n2], v[4 + n2], v[8 + n2], v[12 + n2]);
  // v[4 k1 + n2] now holds the n2-th sequence's bin k1
  v[5] = w16_1(v[5]);
  v[9] = w16_2(v[9]);
  v[13] = w16_3(v[13]);
  v[6] = w16_2(v[6]);
  v[10] = mul_mi(v[10]);
  v[14] = w16_6(v[14]);
  v[7] = w16_3(v[7]);
  v[11] = w16_6(v[11]);
  v[15] = w16_9(v[15]);
  double2 o[16];
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    dft4(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) o[k1 + 4 * k2] = v[4 * k1 + k2];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = o[k];
}

// The largest power of two <= r (r >= 1).
__host__ __device__ constexpr int top_bit(int r) {
  return r >= 8 ? 8 : r >= 4 ? 4 : r >= 2 ? 2 : 1;
}

// v[r] *= w^r for 1 <= r < R, w = exp(-2 pi i jm / (Ns R)): the table t
// (at jm, rows Ns apart) holds w^1, w^2, w^4 and w^8; the others are
// products w^b w^(r - b), b = top_bit(r).
template <int R>
__device__ __forceinline__ void twiddle(double2* v,
                                        const double2* __restrict__ t,
                                        int Ns) {
  constexpr int rows = R == 16 ? 4 : 3;
  double2 w[R];
#pragma unroll
  for (int row = 0; row < rows; ++row) w[1 << row] = __ldg(t + row * Ns);
#pragma unroll
  for (int r = 1; r < R; ++r) {
    if (r != top_bit(r)) w[r] = cmul(w[top_bit(r)], w[r - top_bit(r)]);
    v[r] = cmul(v[r], w[r]);
  }
}

// One Stockham pass of radix R (16 or 8) after Ns points have been
// combined, P_THREAD / R butterflies a thread: butterfly j loads load(j +
// r*n/R), twiddles (twiddle; jm = j % Ns), DFTs in registers and narrows
// to float32; then, after a block barrier where sync (the pass writes
// where it read), stores store((j - jm)*R + jm + r*Ns, value).
template <int R, class Load, class Store>
__device__ __forceinline__ void fast_pass(int n, int Ns,
                                          const double2* __restrict__ tw,
                                          Load load, Store store, bool sync) {
  constexpr int S = P_THREAD / R;
  const int nb = n / R;
  float2 o[S][R];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = threadIdx.x + s * blockDim.x;
    if (j < nb) {
      double2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = wide(load(j + r * nb));
      if (Ns > 1) twiddle<R>(v, tw + (j & (Ns - 1)), Ns);
      if constexpr (R == 16) dft16(v);
      else dft8(v);
#pragma unroll
      for (int r = 0; r < R; ++r) o[s][r] = narrow(v[r]);
    }
  }
  if (sync) __syncthreads();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = threadIdx.x + s * blockDim.x;
    if (j < nb) {
      const int jm = j & (Ns - 1), b = (j - jm) * R + jm;
#pragma unroll
      for (int r = 0; r < R; ++r) store(b + r * Ns, o[s][r]);
    }
  }
}

// A pass of radix R (4, 2 or odd) after Ns points, as a direct sum, at
// most P_THREAD outputs a thread: output (j - jm)*R + jm + k*Ns (j < n/R,
// jm = j % Ns, k < R) is sum_r load(j + r*n/R) exp(-2 pi i r (jm + k Ns) /
// (Ns R)), from tw[e] = exp(-2 pi i e / n); stored after a block barrier
// where sync. Rolled loops, the outputs in local memory: a path of the
// plans that are not 16^a * 8 only, kept small beside the fast passes.
template <class Load, class Store>
__device__ __forceinline__ void sum_pass(int n, int R, int Ns,
                                         const double2* __restrict__ tw,
                                         Load load, Store store, bool sync) {
  const int nb = n / R, f = n / (Ns * R);
  double2 acc[P_THREAD];
#pragma unroll 1
  for (int s = 0; s < P_THREAD; ++s) {
    const int t = threadIdx.x + s * blockDim.x;
    if (t >= n) break;
    const int j = t % nb, k = t / nb;
    const int step = ((j & (Ns - 1)) + k * Ns) * f;  // < n
    double2 a = wide(load(j));
    int e = 0;  // r * step mod n
    for (int r = 1; r < R; ++r) {
      e += step;
      if (e >= n) e -= n;
      a = cadd(a, cmul(wide(load(j + r * nb)), __ldg(tw + e)));
    }
    acc[s] = a;
  }
  if (sync) __syncthreads();
#pragma unroll 1
  for (int s = 0; s < P_THREAD; ++s) {
    const int t = threadIdx.x + s * blockDim.x;
    if (t >= n) break;
    const int j = t % nb, k = t / nb, jm = j & (Ns - 1);
    store((j - jm) * R + jm + k * Ns, narrow(acc[s]));
  }
}

template <class Load, class Store>
__device__ __forceinline__ void any_pass(const Plan& pl, int p,
                                         const double2* __restrict__ tw,
                                         Load load, Store store, bool sync) {
  const int R = pl.R[p], Ns = pl.Ns[p];
  const double2* t = tw + pl.tw[p];
  if (R == 16) fast_pass<16>(pl.n, Ns, t, load, store, sync);
  else if (R == 8) fast_pass<8>(pl.n, Ns, t, load, store, sync);
  else sum_pass(pl.n, R, Ns, t, load, store, sync);
}

// A persistent grid: each block takes work items w = (frame pair p,
// utterance b), p fastest, from the launch's counter until none is left (so
// blocks that finish early take more, as the hardware's block scheduler
// would): its first item is its own (blockIdx.x), and it takes each next
// one while the item before runs. A pair is the real frames f0 = 2p and f1
// = 2p + 1 (a zero frame when f1 = F) in one complex transform, z = x0 +
// i x1.
// first: the spectra are the magnitudes with zero phase. Otherwise: the
// pair's frames of the reflect-padded signal yp, windowed, forward FFT,
// split into the two spectra, each bin k <= n/2 scaled to its magnitude
// (phase with a 1e-8 floor), merged with Hermitian halves. Then inverse
// FFT: the frames are its real and imaginary parts / n, windowed.
// The steps that read and write the exchange buffer x run from one loop
// (the forward transform's passes after the first, the spectral step, the
// inverse's passes but the last), so each kind of pass is compiled once.
__global__ void __launch_bounds__(NT_MAX)
gl_frame_kernel(const float* __restrict__ yp, const float* __restrict__ mag,
                const float* __restrict__ win,
                const double2* __restrict__ tw, float* __restrict__ frames,
                int* __restrict__ next, const Plan pl, int off, int len,
                int hop, int F, int F2, int ly, int n_items, int first) {
  extern __shared__ float2 x[];  // the item's exchange buffer, n points
  __shared__ int s_w;     // the next item, taken while this one runs
  __shared__ Plan s_pl;   // the plan, indexed by pass at run time
  const int n = pl.n, np = pl.np, h2 = n / (2 * N1), pairs = (F + 1) / 2;
  const float inv_n = 1.f / (float)n;
  const auto ld = [](int i) { return x[xi(i)]; };
  const auto st = [](int i, float2 v) { x[xi(i)] = v; };
  if (threadIdx.x == 0) s_pl = pl;
  // the in-place steps an item: forward passes 1 .. np - 1 (none when
  // first), the spectral step, inverse passes 0 .. np - 2
  const int n_fwd = first ? 0 : np - 1, n_steps = n_fwd + np;
  // the first item is the block's own, the next ones from the counter
  int w = blockIdx.x;
  for (bool later = false;; later = true) {
    __syncthreads();  // the last item's reads of x are done; s_w is set
    if (later) w = s_w;
    if (w >= n_items) break;
    int w_next = 0;  // read at the item's end: the atomic's wait is hidden
    if (threadIdx.x == 0) w_next = gridDim.x + atomicAdd(next, 1);
    const int f0 = 2 * (w % pairs), b = w / pairs;
    const bool two = f0 + 1 < F;
    if (!first) {
      // the window is zero outside [off, off + len): read the span only
      const float* x0 = yp + (size_t)b * ly + (size_t)f0 * hop;
      const float* x1 = x0 + hop;
      fast_pass<16>(
          n, 1, tw,
          [x0, x1, win, two, off, len](int i) {
            if ((unsigned)(i - off) >= (unsigned)len)
              return make_float2(0.f, 0.f);
            return make_float2(x0[i] * win[i], two ? x1[i] * win[i] : 0.f);
          },
          st, false);
    }
    for (int step = 0; step < n_steps; ++step) {
      __syncthreads();  // the last step's stores are done
      if (step != n_fwd) {
        any_pass(s_pl, step < n_fwd ? step + 1 : step - n_fwd - 1, tw, ld,
                 st, true);
        continue;
      }
      // the spectral step: bins k < n/2 as (k1, k2) = (k % 16, k / 16), k2
      // fastest, so the magnitude reads coalesce; i = n/2 is the Nyquist
      // bin. In place: a thread reads and writes bins k and n - k only.
      const size_t row = (size_t)F2 * 2 * h2;  // one k1 of the layout
      const float* m0 = mag + (size_t)b * N1 * row + (size_t)f0 * 2 * h2;
      for (int i = threadIdx.x; i <= n / 2; i += blockDim.x) {
        const int k1 = i < n / 2 ? i / h2 : 0, k2 = i < n / 2 ? i % h2 : h2;
        const int k = k1 + N1 * k2;
        const float g0 = m0[k1 * row + k2];
        const float g1 = two ? m0[k1 * row + 2 * h2 + k2] : 0.f;
        float2 p, q;  // the two re-imposed spectra at bin k
        if (first) {
          p = make_float2(g0, 0.f);
          q = make_float2(g1, 0.f);
        } else {
          const float2 a = x[xi(k)], c = x[xi(k ? n - k : 0)];
          // X = (Z[k] + conj Z[n-k]) / 2, Y = (Z[k] - conj Z[n-k]) / 2i
          p = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
          q = make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x));
          const float sx = g0 / fmaxf(1e-8f, sqrtf(p.x * p.x + p.y * p.y));
          const float sy = g1 / fmaxf(1e-8f, sqrtf(q.x * q.x + q.y * q.y));
          p = make_float2(p.x * sx, p.y * sx);
          q = make_float2(q.x * sy, q.y * sy);
        }
        // conj W[k] = conj(X + iY), conj W[n-k] = conj(conj X + i conj Y)
        x[xi(k)] = make_float2(p.x - q.y, -(p.y + q.x));
        if (k != 0 && 2 * k != n)
          x[xi(n - k)] = make_float2(p.x + q.y, p.y - q.x);
      }
    }
    __syncthreads();
    // frames hold the window's span only: sample i at i - off
    float* d0 = frames + ((size_t)b * F + f0) * len;
    float* d1 = d0 + len;
    any_pass(s_pl, np - 1, tw, ld,
             [d0, d1, win, inv_n, two, off, len](int i, float2 v) {
               if ((unsigned)(i - off) >= (unsigned)len) return;
               // w = ifft(W) = conj(fft(conj W)) / n
               d0[i - off] = v.x * inv_n * win[i];
               if (two) d1[i - off] = -v.y * inv_n * win[i];
             },
             false);
    if (threadIdx.x == 0) s_w = w_next;
  }
}

}  // namespace

// The transform's plan from ops/gl2.py:fft_passes, (R, Ns, twiddle offset)
// a pass; false unless it is one the kernel runs: radix 16 first, then 16,
// 8, 4, 2 or odd, each pass after the points the ones before it combined, n
// in all, at least two passes, every table inside the n_tw twiddles (a
// pass of 16 or 8 after Ns > 1: log2(R) rows of Ns; of 4, 2 or odd: n).
static bool take_plan(int n, const int* passes, int np, int n_tw, Plan* pl) {
  if (n < 1 || n > P_THREAD * NT_MAX || np < 2 || np > MAX_PASSES ||
      n_tw < 0 || passes[0] != 16)
    return false;
  int Ns = 1;
  for (int p = 0; p < np; ++p) {
    const int R = passes[3 * p], tw = passes[3 * p + 2];
    const bool fast = R == 16 || R == 8;
    const int size = fast ? (Ns > 1 ? (R == 16 ? 4 : 3) * Ns : 0) : n;
    if (passes[3 * p + 1] != Ns || R < 2 ||
        !(fast || R == 4 || R == 2 || R % 2) || Ns > n / R || tw < 0 ||
        tw + size > n_tw)
      return false;
    pl->R[p] = R;
    pl->Ns[p] = Ns;
    pl->tw[p] = tw;
    Ns *= R;
  }
  pl->n = n;
  pl->np = np;
  return Ns == n;
}

// The frame kernel's launch: threads an item (n/16 in whole warps), its
// dynamic shared memory (the exchange buffer) and the persistent grid: as
// many blocks as fit on every SM at once (the occupancy query), times the
// SMs. info (host memory, may be null): the grid, threads a block, blocks
// a SM and the kernel's registers a thread.
static cudaError_t frame_launch(const Plan& pl, int n_items, int* nt,
                                size_t* smem, int* grid, int* info) {
  *nt = (pl.n / P_THREAD + 31) / 32 * 32;
  *smem = sizeof(float2) * (size_t)pl.n;
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
                                                    *nt, *smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = sms * per_sm < n_items ? sms * per_sm : n_items;
  if (info) {
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, gl_frame_kernel)) != cudaSuccess)
      return e;
    info[0] = *grid;
    info[1] = *nt;
    info[2] = per_sm;
    info[3] = attr.numRegs;
  }
  return cudaSuccess;
}

// Every round of Griffin-Lim. passes: the host's (n_passes, 3) plan
// (ops/gl2.py:fft_passes); tw: its n_tw twiddles, double2; info: see
// frame_launch.
extern "C" int dctts_gl2(const float* mag, const float* win, const float* wsq,
                         const double* tw, float* frames, float* yp,
                         float* out, int* counters, const int* passes,
                         int n_passes, int B, int n_fft, int hop, int F,
                         int F2, int pad, int L_sig, int n_iter, int n_tw,
                         int off, int len, int* info, void* stream) {
  Plan pl;
  if (!take_plan(n_fft, passes, n_passes, n_tw, &pl) || B < 1 || F < 1 ||
      n_iter < 0 || off < 0 || len < 1 || off + len > n_fft)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ly = n_fft + hop * (F - 1), n_items = (F + 1) / 2 * B;
  size_t smem;
  int nt, blocks;
  cudaError_t e = frame_launch(pl, n_items, &nt, &smem, &blocks, info);
  if (e != cudaSuccess) return (int)e;
  // one work counter per frame-kernel launch
  e = cudaMemsetAsync(counters, 0, sizeof(int) * (size_t)(n_iter + 1), st);
  if (e != cudaSuccess) return (int)e;
  const double2* tw2 = reinterpret_cast<const double2*>(tw);
  const dim3 ogrid((ly + GL_NT - 1) / GL_NT, B),
      wgrid((L_sig + GL_NT - 1) / GL_NT, B);
  gl_frame_kernel<<<blocks, nt, smem, st>>>(yp, mag, win, tw2, frames,
                                            counters, pl, off, len, hop, F,
                                            F2, ly, n_items, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int it = 0; it < n_iter; ++it) {
    gl_ola_kernel<<<ogrid, GL_NT, 0, st>>>(frames, wsq, yp, off, len, hop, F,
                                           pad, L_sig, ly, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    gl_frame_kernel<<<blocks, nt, smem, st>>>(yp, mag, win, tw2, frames,
                                              counters + it + 1, pl, off,
                                              len, hop, F, F2, ly, n_items,
                                              0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  gl_ola_kernel<<<wgrid, GL_NT, 0, st>>>(frames, wsq, out, off, len, hop, F,
                                         pad, L_sig, L_sig, 1);
  return (int)cudaGetLastError();
}
