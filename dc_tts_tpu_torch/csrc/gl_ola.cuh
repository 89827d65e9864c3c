// The Griffin-Lim overlap-add pass shared by kernels K2 (gl2.cu) and K3
// (gl.cu): windowed frames in device memory -> the signal the next round
// re-frames, or the final waveform.
#pragma once

#include <cuda_runtime.h>

#define GL_NT 256

namespace {

// One thread per output sample. Frame f holds samples [f*hop + off, f*hop +
// off + len) of the signal, len floats a row (K3: the whole n-sample frame,
// off = 0, len = n; K2: the window's nonzero span). The overlap-add of the
// frames covering sample s, summed from the last frame back (the TPU
// kernels' order), times 1/sum(w^2). Not final: dst is the reflect-padded
// signal of length ly, whose edges mirror s = 2*pad - j (left) and s = 2*E
// - j (right, E = pad + L - 1). Final: dst is the trimmed waveform, s = pad
// + j.
__global__ void __launch_bounds__(GL_NT)
gl_ola_kernel(const float* __restrict__ frames, const float* __restrict__ wsq,
              float* __restrict__ dst, int off, int len, int hop, int F,
              int pad, int L, int n_out, int final_) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * GL_NT + threadIdx.x;
  if (j >= n_out) return;
  int s;
  if (final_) {
    s = pad + j;
  } else {
    const int e = pad + L - 1;
    s = j < pad ? 2 * pad - j : (j > e ? 2 * e - j : j);
  }
  const int u = s - off, t = u - len + 1;
  const int f_hi = u < 0 ? -1 : min(F - 1, u / hop);
  const int f_lo = t <= 0 ? 0 : (t + hop - 1) / hop;
  const float* fb = frames + (size_t)b * F * len;
  float acc = 0.f;
  for (int f = f_hi; f >= f_lo; --f)
    acc += fb[(size_t)f * len + (u - f * hop)];
  dst[(size_t)b * n_out + j] = acc * wsq[s];
}

}  // namespace
