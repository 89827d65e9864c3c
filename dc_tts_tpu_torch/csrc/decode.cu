// Kernel K1: the whole Text2Mel autoregressive decode in one cooperative
// launch, the weights of every layer split over all the blocks.
//
// Replaces dc_tts_tpu/ops/pallas_decode.py:fused_decode (body
// _decode_kernel). The design note is in dc_tts_tpu_torch/ops/decode.py.
// One persistent 512-thread block per SM, in clusters of CLW blocks (a
// template parameter: CL, or CL_WIDE in the wide kernel; a cooperative
// launch, so all are co-resident). Block g owns the output columns
// [g*W/G, (g+1)*W/G) of every layer of width W and computes them for all B
// batch rows, so each weight is read once a step on the whole card; its
// slice of the weights (columns contiguous: the transposed slots of
// pack_decode_params) sits in shared memory where the host's plan found
// room and streams from L2 otherwise. A product task is RG rows x 4 columns
// (2 under the split), one warp; the lanes split k and the task's sums are
// reduced together. At large B the plan takes the wide kernel (WIDE; the
// grid exchange's common configs, e.g. B = 72): its float32 and bf16
// products take tasks of RG_WIDE rows (an HC layer's 27 tasks at B = 72 are
// 2 rounds of the 16 warps, not 54 tasks in 4), and every slice lies in
// shared memory: the slices that find no room share one staging slot, into
// which the copy engine brings each one step by step while the layer
// before it in their cycle exchanges its rows (fetch_slice). The pre-norm
// rows h are exchanged in one of two ways (the wrapper's plan picks one;
// separate instantiations, FLAG):
// - the grid exchange (large B): each block writes its columns of h to a
//   global buffer; one grid barrier (a counter in global memory; a wait of
//   more than 10 s traps, so the launch fails instead of hanging); then the
//   block of cluster rank r reads the full rows b = r, r + CLW, ... of h
//   (B / CLW rows: 36 a block at B = 72 in clusters of 2, so some of its 16
//   warps take three in turn, 9 in the wide kernel's of 8), normalises
//   them, one warp a row, and stores the layer's
//   output rows into the copies of every block of its cluster (distributed
//   shared memory), and a cluster barrier of the CLW blocks closes the
//   layer: a grid and a cluster barrier a layer, 24 of each a step at
//   base_config;
// - the flagged exchange (small B, every row in shared memory): each block
//   publishes its columns of h as 8-byte words of a value and the
//   exchange's epoch, then gathers the full rows, waiting on each word until
//   it carries the epoch (NCCL's "LL" protocol), and normalises every row
//   into its own copy: one L2 round trip a layer and no barrier. Every
//   block computes the same bits, so the copies agree.
// The attention row is computed in every block for every row: the
// arithmetic is identical, so the cursors agree without a barrier. In the
// wide kernel's clusters of CL_WIDE each rank computes the attention of its
// norm rows alone and stores their [ctx; q] into its cluster's copies, and
// a cluster barrier follows (attention_split). The
// config's widths are free, as the TPU kernel's are (only its VMEM bounds
// it): the attention walks the window in register chunks of MAX_WIN keys
// and the features in chunks of 256; each tap of a weight slot is padded to
// the 16-byte copy width with zero weights (ops/decode.py:kernel_slot), so
// any d and n_mels run; a row wider than a lane's registers hold (C > 512,
// HC > 256) is normalised by a second loop. Those paths live in a second
// instantiation of the kernel (GEN), launched only for a config that needs
// them: code the common case never runs still cost it 2-13 % (PERF.md);
// such a config takes the grid exchange.
// Only shared memory and co-residency refuse a config
// (ops/decode.py:decode_plan). An
// HC layer's product x_t @ W is three products, one per tap; the block
// keeps the two older taps' products of its columns (x_s @ W_tap) in a
// private ring in global memory and adds them when the lag comes round, so
// a step reads only x_t. What a phase can load early it loads under the
// product: the ring's taps and the bias for the combine, the norms'
// parameters (cp.async).
//
// Bound on the H100: the step is a dependent chain of 24 layer products of
// a few MFLOP each. The card's operation and byte bounds are far below the
// chain's floor, which the barriers and L2 round trips set; a phase that
// runs once a layer on a few warps is paced by its latency and by
// fetching its code, so the per-layer phases are kept short (rolled loops,
// one sigmoid in the code).
//
// Numerics: no fast math, sigmoid as 1/(1+expf(-x)), layer norm
// (x-mu)*rsqrt(var+eps) with the biased variance (two passes), the
// attention cursor the FIRST argmax of the softmax output. A product
// column's sum over k: lane l of a warp sums k = 128i + 4l + e (i, then
// e = 0..3, in order) with FFMA, then the 32 lanes' sums are added over xor
// distances 16, 8, 4, 2, 1 (a reduce-scatter that pairs them as a
// butterfly does); an HC column is ((older tap + middle tap) + current tap)
// + bias. The precisions of the JAX kernel's mm, per layer: WK_F32 float32
// FFMA ("highest", and AudioEnc under "hybrid"); WK_SPLIT the bf16 split
// xh@Wh + xh@Wl + xl@Wh, the activations split as they are loaded (round
// to nearest even), three float32 sums a column added as (hh + hl) + lh
// ("high3", and AudioDec under "hybrid"); WK_BF16 one pass over bf16
// weights and rounded activations ("default"). A product of two bf16
// values is exact in float32, so FFMA on the widened halves gives the
// tensor core's products; only the order of the sums differs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

#define NT 512          // threads per block
#define NW (NT / 32)    // warps per block
#define RG 4            // batch rows of one product task; RG in ops/decode.py
#define RG_WIDE 8       // the grid exchange's wide tasks; RG_WIDE there
#define CL 2            // blocks of a cluster; CLUSTER in ops/decode.py
#define CL_WIDE 8       // the wide kernel's; WIDE_CLUSTER there
#define MAX_LAYERS 32
#define MAX_WIN 8       // attention keys of a register chunk (any window)
#define ROW_WIN 4       // the most keys attention_row takes
#define FCH 8           // attention features a lane holds, a chunk of 256
#define LAYER_INTS 14   // ints per layer in the host's program array
#define LAYER_PTRS 4    // pointers per layer
#define XG 4            // words a thread has in flight in gather_rows

#define WK_F32 0        // WKINDS in ops/decode.py, in order
#define WK_BF16 1
#define WK_SPLIT 2

// The phases the stamped twins time (PHASES in ops/decode.py, in order),
// and the words of a block's record (STAMP_WORDS there): each phase's
// cycles, the block's cycles, %globaltimer at its start and at its end; a
// stamped twin's running record takes sizeof(StampRecord), 128 bytes, of
// static shared memory (STAMP_SMEM there).
#define PH_PROLOGUE 0
#define PH_PRODUCT 1
#define PH_EXCHANGE 2
#define PH_NORM 3
#define PH_ATTENTION 4
#define N_PHASES 5
#define STAMP_WORDS (N_PHASES + 3)

namespace {

typedef unsigned short bf16_t;  // bf16 bits

struct Layer {
  const void* w;     // the layer's transposed slot: row c holds column c's
                     // weights over k (hi halves under WK_SPLIT)
  const void* wl;    // WK_SPLIT: the lo halves' slot
  const float* bias;
  const float* ln;   // C: gamma (cmo), beta (cmo); HC: 4 x C
  int kind;          // 0 = C, 1 = HC
  int cin, cout;     // HC: cin = cout = C, the residual width
  int rate, act;     // act: 0 none, 1 relu, 2 sigmoid
  int ring_off;      // HC: first ring row
  int wkind, ldw;    // the slot rows' pitch in elements
  int woff;          // byte offset of the block's slice in shared memory
                     // (resident, or the staging slot), or -1 (L2)
  int nmax;          // most columns a block owns
  int kp;            // a tap's depth, padded to 4 with zero weights
  int lnv;           // 1: the norm parameters copy as aligned 16-byte chunks
  int fetch;         // the staged layer whose slice this layer fetches into
                     // the staging slot under its exchange, or -1
  int rg;            // rows of a product task: RG, or RG_WIDE
};

struct Program {
  int n_enc, n_dec;
  Layer l[MAX_LAYERS];
};

struct Args {
  const float* kt;  // (B, N, d)
  const float* v;   // (B, N, d)
  float* y;         // (B, T, n_mels)
  float* a;         // (B, N, T)
  float* hbuf;      // grid exchange: 2 x (B, ldh), the pre-norm rows
  uint2* words;     // flagged exchange: 2 x (B, ldx) {value, epoch} words
  float* ring;      // blocks x ring_floats: each block's tap products
  float* spill;     // blocks x spill_floats: activation rows past rows_sh
  unsigned* bar;    // the grid barrier's counter, 0 at launch
  int B, N, d, n_mels, T, win, cmo, xw, ldh;
  int rows_sh, ring_floats, spill_floats, part_off, prev_off, ln_off;
  int z_off, nv_max, ldx;
  int stage0;       // the first staged layer (in the slot at launch), or -1
  int sbar_off;     // bytes: the staging slot's mbarrier
  unsigned epoch0;  // the flagged exchange's first epoch
  float eps, scale;
  uint64_t* stamps;  // the stamped twins: blocks x STAMP_WORDS, the records
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The stamped twins' timer (STAMP). A reading of the SM clock at each
// boundary the loop already has, after the barriers and waits that stand
// there, ends one phase and begins the next, so the phases tile the block's
// run; the record (StampRecord, in shared memory: every instantiation runs
// at its 128-register cap) sums each phase's cycles. At a boundary right
// after a block barrier every thread reads the same moment, so the reading
// is the stamping thread's, STAMPER, the last warp's first lane: the last
// warp takes the fewest product tasks (tasks go to warps in turn) and, up
// to B = 15 x the cluster width, no norm row, so its readings, each of
// which waits on a load of the record, are off the block's critical path
// (thread 0 stamping every boundary cost 2.2-2.7 %; PERF.md). Where no
// barrier stands (a block's norms under the grid exchange, its combine
// under the flagged one) the end is warp 0's, which takes the most rows
// and tasks: thread 0 only stores its reading (note), which the stamping
// thread books at the next boundary (mark2). At the end the stamping
// thread writes the block's record to out (blocks x STAMP_WORDS: the
// phases' cycles, the block's cycles, %globaltimer at its start and at its
// end). Without STAMP each call compiles to nothing.
#define STAMPER (NT - 32)

// 128 bytes: the dynamic shared memory, placed after it, keeps the
// alignment to 128 bytes it has in the unstamped kernel (with an 80-byte
// record the wide kernel's twin ran 10 % slower, with this one 0.6 %)
struct __align__(128) StampRecord {
  uint64_t total[N_PHASES];  // cycles of each phase
  uint64_t last;             // the last booked reading
  uint64_t first;            // the first reading
  uint64_t start_ns;         // %globaltimer at the first reading
  uint64_t noted;            // thread 0's reading, not yet booked
};

template <bool STAMP>
struct Stamps {
  static __device__ __forceinline__ void start() {}
  static __device__ __forceinline__ void mark(int) {}
  static __device__ __forceinline__ void note() {}
  static __device__ __forceinline__ void mark2(int, int) {}
  static __device__ __forceinline__ void finish(uint64_t*) {}
};

template <>
struct Stamps<true> {
  static __device__ __forceinline__ StampRecord& rec() {
    __shared__ StampRecord r;
    return r;
  }
  static __device__ __forceinline__ void start() {
    if (threadIdx.x != STAMPER) return;
    StampRecord& r = rec();
    r.start_ns = sm90::global_ns();
    r.first = r.last = clock64();
    for (int i = 0; i < N_PHASES; ++i) r.total[i] = 0;
  }
  // ends phase `end` and begins the next
  static __device__ __forceinline__ void mark(int end) {
    if (threadIdx.x != STAMPER) return;
    StampRecord& r = rec();
    const uint64_t now = clock64();
    r.total[end] += now - r.last;
    r.last = now;
  }
  // thread 0's reading, which ends a phase the next mark2 books
  static __device__ __forceinline__ void note() {
    if (threadIdx.x == 0) rec().noted = clock64();
  }
  // books `ended` up to the noted reading (kept between the last booked
  // one and now: a block whose warp 0 had no norm row may note before the
  // stamping thread's reading after the same barrier), then `end` up to now
  static __device__ __forceinline__ void mark2(int ended, int end) {
    if (threadIdx.x != STAMPER) return;
    StampRecord& r = rec();
    const uint64_t now = clock64();
    const uint64_t at = r.noted < r.last ? r.last
                        : r.noted > now ? now : r.noted;
    r.total[ended] += at - r.last;
    r.total[end] += now - at;
    r.last = now;
  }
  static __device__ __forceinline__ void finish(uint64_t* out) {
    if (threadIdx.x != STAMPER) return;
    const StampRecord& r = rec();
    uint64_t* o = out + (size_t)blockIdx.x * STAMP_WORDS;
    for (int i = 0; i < N_PHASES; ++i) o[i] = r.total[i];
    o[N_PHASES] = r.last - r.first;
    o[N_PHASES + 1] = r.start_ns;
    o[N_PHASES + 2] = sm90::global_ns();
  }
};

// Every block arrives once; the counter only grows, so the k-th barrier of
// a launch waits for k * gridDim.x arrivals. The stamped twins' product
// ends at its first block barrier.
template <bool STAMP>
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  __syncthreads();
  Stamps<STAMP>::mark(PH_PRODUCT);
  target += gridDim.x;
  if (threadIdx.x == 0) {
    // a release: the block's stores, ordered before it by __syncthreads,
    // are visible to whoever acquires the count
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar)
                 : "memory");
    const uint64_t t0 = sm90::global_ns();
    unsigned seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(bar) : "memory");
      if ((int)(seen - target) >= 0) break;
      if (sm90::global_ns() - t0 > 10000000000ull) __trap();
    }
  }
  __syncthreads();
}

// The flagged exchange: a value travels with its exchange's epoch in one
// aligned 8-byte word, stored and loaded whole (NCCL's "LL" protocol), so a
// reader that finds the epoch it waits for also holds the value, with no
// fence and no barrier. The wrapper zeroes the words (0 is no epoch) and
// hands each launch fresh epochs, one an exchange, so no word of an earlier
// exchange passes. Two parities suffice: no block publishes layer l + 2
// before every block has gathered layer l (it waits on their layer l + 1).
__device__ __forceinline__ void publish(uint2* w, float v, unsigned e) {
  asm volatile("st.volatile.global.v2.u32 [%0], {%1, %2};\n" ::"l"(w),
               "r"(__float_as_uint(v)), "r"(e) : "memory");
}

__device__ __forceinline__ uint2 peek(const uint2* w) {
  uint2 q;
  asm volatile("ld.volatile.global.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(q.x), "=r"(q.y) : "l"(w) : "memory");
  return q;
}

// Rows of RW values from their words at hw (a pitch of ldx) into z (a
// pitch of ldz) once each word carries epoch e: the block's threads take
// words i, i + NT, ..., XG of them in flight, and read a stale word again
// until it carries e; a wait of more than 10 s traps. (Reading all of a
// thread's stale words again together costs more at B = 1 and 2, the
// batches this exchange serves, than it saves past them: PERF.md.)
__device__ void gather_rows(const uint2* hw, int ldx, int rows, int RW,
                            unsigned e, float* z, int ldz) {
  const int n = rows * RW;
  uint64_t t0 = 0;
  for (int i0 = threadIdx.x; i0 < n; i0 += XG * NT) {
    uint2 q[XG];
#pragma unroll
    for (int u = 0; u < XG; ++u) {
      const int i = i0 + u * NT;
      if (i < n) q[u] = peek(hw + (size_t)(i / RW) * ldx + i % RW);
    }
#pragma unroll
    for (int u = 0; u < XG; ++u) {
      const int i = i0 + u * NT;
      if (i >= n) break;
      while (q[u].y != e) {
        const uint64_t now = sm90::global_ns();
        if (!t0) t0 = now;
        else if (now - t0 > 10000000000ull) __trap();
        q[u] = peek(hw + (size_t)(i / RW) * ldx + i % RW);
      }
      z[(size_t)(i / RW) * ldz + i % RW] = __uint_as_float(q[u].x);
    }
  }
}

// A batch row of the activations: in shared memory for the first rows_sh
// rows, in the block's global spill after that.
__device__ __forceinline__ float* xrow(const Args& p, float* xs, float* xg,
                                       int b) {
  return b < p.rows_sh ? xs + (size_t)b * p.xw
                       : xg + (size_t)(b - p.rows_sh) * p.xw;
}

// Row b of the activations in cluster member q's copy: its shared memory
// (through the cluster's distributed shared memory) or its global spill.
__device__ __forceinline__ float* xrow_in(const Args& p, float* xs, int q,
                                          int b) {
  cg::cluster_group cluster = cg::this_cluster();
  if (b < p.rows_sh)
    return cluster.map_shared_rank(xs, q) + (size_t)b * p.xw;
  const int g = blockIdx.x - (int)cluster.block_rank() + q;
  return p.spill + (size_t)g * p.spill_floats + (size_t)(b - p.rows_sh) * p.xw;
}

// Four activations of row b from column k: a row in the global spill may
// have been stored by the cluster peer, so it is read past an L1 that may
// hold the line from before (volatile: legal on a generic address of
// either space, should the compiler load it speculatively).
__device__ __forceinline__ float4 load_x4(const Args& p, const float* row,
                                          int b, int k) {
  if (b < p.rows_sh) return *reinterpret_cast<const float4*>(row + k);
  const volatile float* v = row + k;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void load4(const float* w, float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(w);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}

__device__ __forceinline__ void load4(const bf16_t* w, float (&o)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(w);  // lower address low
  o[0] = __uint_as_float(q.x << 16);
  o[1] = __uint_as_float(q.x & 0xffff0000u);
  o[2] = __uint_as_float(q.y << 16);
  o[3] = __uint_as_float(q.y & 0xffff0000u);
}

template <int WK> struct WType { typedef bf16_t type; };
template <> struct WType<WK_F32> { typedef float type; };

// v[0..M) of every lane (M = 8, 16 or 32) -> the sum over the 32 lanes of
// v[j] lands in lanes j * 32 / M .. (j + 1) * 32 / M - 1: a reduce-scatter
// over xor distances O = 16, 8, ... while more than one value is left (a
// compile-time recursion, so that v stays in registers), then butterfly
// steps over the rest. Each sum is formed by the same pairs, in the same
// order, as warp_sum's butterfly, so the two give the same bits.
template <int M, int O = 16>
__device__ __forceinline__ float reduce_scatter(float* v) {
  if constexpr (M == 1) {
    float s = v[0];
#pragma unroll
    for (int o = O; o >= 1; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
  } else {
    const bool up = threadIdx.x & O;  // keeps the upper half of the values
#pragma unroll
    for (int j = 0; j < M / 2; ++j) {
      const float send = up ? v[j] : v[j + M / 2];
      const float got = __shfl_xor_sync(0xffffffffu, send, O);
      v[j] = (up ? v[j + M / 2] : v[j]) + got;
    }
    return reduce_scatter<M / 2, O / 2>(v);
  }
}

// The block's columns [c0, c0 + n) of the layer's product for all rows.
// A virtual column is one output column (C) or one tap of one (HC: 3 per
// column, tap 0 the oldest); a task is RG rows x VG virtual columns, one
// warp, whose RG * VG sums are reduced together (VG = 4, 2 under WK_SPLIT,
// whose three sums a value need the registers). The sums land in
// part[b * nv_max + v].
template <int WK>
__device__ void product(const Args& p, const Layer& L, int c0, int n,
                        float* xs, float* xg, float* part, const char* smem) {
  typedef typename WType<WK>::type wt;
  constexpr int VG = WK == WK_SPLIT ? 2 : 4, M = RG * VG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool hc = L.kind == 1;
  // depth of a virtual column: a tap's inputs, padded with zero weights to
  // the 16-byte copy width (the row's values there are finite: 0 x finite)
  const int K = L.kp;
  const int taps = hc ? 3 : 1;
  const int nv = taps * n;
  const int nvg = (nv + VG - 1) / VG;
  const int nrg = (p.B + RG - 1) / RG;
  const bool res = L.woff >= 0;
  const int pitch = res ? taps * K : L.ldw;
  const wt* wbase = res ? reinterpret_cast<const wt*>(smem + L.woff)
                        : static_cast<const wt*>(L.w) + (size_t)c0 * L.ldw;
  const wt* lbase =
      WK != WK_SPLIT ? wbase
      : res ? wbase + (size_t)L.nmax * pitch
            : static_cast<const wt*>(L.wl) + (size_t)c0 * L.ldw;
  for (int task = warp; task < nrg * nvg; task += NW) {
    const int v0 = (task % nvg) * VG, r0 = (task / nvg) * RG;
    const int rows = min(RG, p.B - r0), cols = min(VG, nv - v0);
    const float* xr[RG];
    int wo[VG];  // elements from the slice's start to each column's taps
#pragma unroll
    for (int r = 0; r < RG; ++r)
      xr[r] = xrow(p, xs, xg, r0 + min(r, rows - 1));
#pragma unroll
    for (int c = 0; c < VG; ++c) {
      const int v = v0 + min(c, cols - 1);
      wo[c] = (v / taps) * pitch + (v % taps) * K;
    }
    // sums [r * VG + c]: hh, and under WK_SPLIT hl and lh
    float hh[M], hl[M], lh[M];
#pragma unroll
    for (int i = 0; i < M; ++i) hh[i] = hl[i] = lh[i] = 0.f;
#pragma unroll 1
    for (int k = 4 * lane; k < K; k += 128) {
      float xa[RG][4], xl[RG][4], w[VG][4], wl[VG][4];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const float4 q = load_x4(p, xr[r], r0 + r, k);
        xa[r][0] = q.x; xa[r][1] = q.y; xa[r][2] = q.z; xa[r][3] = q.w;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (WK != WK_F32) {
            const float h = bf16_round(xa[r][e]);
            xl[r][e] = bf16_round(xa[r][e] - h);
            xa[r][e] = h;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < VG; ++c) {
        load4(wbase + wo[c] + k, w[c]);
        if (WK == WK_SPLIT) load4(lbase + wo[c] + k, wl[c]);
      }
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int c = 0; c < VG; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r * VG + c;
            hh[i] = fmaf(xa[r][e], w[c][e], hh[i]);
            if (WK == WK_SPLIT) {
              hl[i] = fmaf(xa[r][e], wl[c][e], hl[i]);
              lh[i] = fmaf(xl[r][e], w[c][e], lh[i]);
            }
          }
    }
    float s = reduce_scatter<M>(hh);
    if (WK == WK_SPLIT)
      s = (s + reduce_scatter<M>(hl)) + reduce_scatter<M>(lh);
    const int i = lane / (32 / M), r = i / VG, c = i % VG;
    if (lane % (32 / M) == 0 && r < rows && c < cols)
      part[(r0 + r) * p.nv_max + v0 + c] = s;
  }
}

// product in tasks of RG_WIDE rows x 4 virtual columns (not WK_SPLIT),
// for the wide kernel, whose plan found every row and every slice in
// shared memory and that the wide tasks take fewer rounds of the warps: at
// B = 72 an HC layer's 54 tasks of RG rows take 4 rounds of the 16 warps,
// its 27 wide ones 2. Each column's sums are product's, in its order, so
// Y and A keep their bits; a k-chunk's weights are loaded first and each
// row's activations used as they arrive, so that 32 sums, 16 weights and
// a row's 4 activations are live, not every row's (the kernel's 128
// registers a thread spill otherwise).
template <int WK>
__device__ void product_wide(const Args& p, const Layer& L, int c0, int n,
                             const float* xs, float* part,
                             const char* smem) {
  typedef typename WType<WK>::type wt;
  constexpr int VG = 4, M = RG_WIDE * VG;
  static_assert(WK != WK_SPLIT, "the split keeps tasks of RG rows");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = L.kp;
  const int taps = L.kind == 1 ? 3 : 1;
  const int nv = taps * n;
  const int nvg = (nv + VG - 1) / VG;
  const int nrg = (p.B + RG_WIDE - 1) / RG_WIDE;
  const int pitch = taps * K;
  const wt* wbase = reinterpret_cast<const wt*>(smem + L.woff);
  for (int task = warp; task < nrg * nvg; task += NW) {
    const int v0 = (task % nvg) * VG, r0 = (task / nvg) * RG_WIDE;
    const int rows = min(RG_WIDE, p.B - r0), cols = min(VG, nv - v0);
    const float* xb = xs + (size_t)r0 * p.xw;
    int wo[VG];  // elements from the slice's start to each column's taps
#pragma unroll
    for (int c = 0; c < VG; ++c) {
      const int v = v0 + min(c, cols - 1);
      wo[c] = (v / taps) * pitch + (v % taps) * K;
    }
    float hh[M];  // sums [r * VG + c]
#pragma unroll
    for (int i = 0; i < M; ++i) hh[i] = 0.f;
#pragma unroll 1
    for (int k = 4 * lane; k < K; k += 128) {
      float w[VG][4];
#pragma unroll
      for (int c = 0; c < VG; ++c) load4(wbase + wo[c] + k, w[c]);
#pragma unroll
      for (int r = 0; r < RG_WIDE; ++r) {
        const float4 q = *reinterpret_cast<const float4*>(
            xb + (size_t)min(r, rows - 1) * p.xw + k);
        float xa[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (WK == WK_BF16) xa[e] = bf16_round(xa[e]);
#pragma unroll
        for (int c = 0; c < VG; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hh[r * VG + c] = fmaf(xa[e], w[c][e], hh[r * VG + c]);
      }
    }
    const float s = reduce_scatter<M>(hh);
    const int r = lane / VG, c = lane % VG;
    if (r < rows && c < cols) part[(r0 + r) * p.nv_max + v0 + c] = s;
  }
}

// The block's columns of the pre-norm rows h (+ bias) into hb, or, under
// the flagged exchange, published into hw with epoch e; an HC column adds
// its older taps' products from the ring and stores this step's.
// What combine adds to element i = (b, j) of the block's columns: the
// older taps' products from the ring (HC) and the bias. The first element
// of each thread is loaded before the product, to arrive under it.
struct Addends {
  float tap0, tap1, bias;
};

__device__ __forceinline__ Addends addends(const Args& p, const Layer& L,
                                           int t, int c0, int n, int i,
                                           const float* ring) {
  const int b = i / n, j = i % n;
  Addends a = {0.f, 0.f, L.bias[c0 + j]};
  if (L.kind == 1) {
    const int R = 2 * L.rate + 1;
    const float* rg =
        ring + ((size_t)L.ring_off * p.B + b) * L.nmax * 2 + 2 * j;
    const size_t row = (size_t)p.B * L.nmax * 2;
    a.tap0 = __ldcg(rg + ((t + 1) % R) * row);
    a.tap1 = __ldcg(rg + ((t + L.rate + 1) % R) * row + 1);
  }
  return a;
}

template <bool FLAG>
__device__ void combine(const Args& p, const Layer& L, int t, int c0, int n,
                        const float* part, float* ring, float* hb,
                        uint2* hw, unsigned e, Addends first) {
  const bool hc = L.kind == 1;
  const int R = 2 * L.rate + 1, wi = t % R;
  for (int i = threadIdx.x; i < p.B * n; i += NT) {
    const int b = i / n, j = i % n, c = c0 + j;
    const Addends a =
        i == threadIdx.x ? first : addends(p, L, t, c0, n, i, ring);
    const float* pp = part + b * p.nv_max;
    float h;
    if (hc) {
      pp += 3 * j;
      float* rg = ring + ((size_t)L.ring_off * p.B + b) * L.nmax * 2 + 2 * j;
      const size_t row = (size_t)p.B * L.nmax * 2;
      h = ((a.tap0 + a.tap1) + pp[2]) + a.bias;
      __stcg(rg + wi * row, pp[0]);
      __stcg(rg + wi * row + 1, pp[1]);
    } else {
      h = pp[j] + a.bias;
    }
    if constexpr (FLAG)
      publish(hw + (size_t)b * p.ldx + c, h, e);
    else
      __stcg(hb + (size_t)b * p.ldh + c, h);
  }
}

// The layer norm(s) of rows from the full pre-norm rows hb, one warp a
// row: C: x <- act(LN(h)) (the last layer: sigmoid, the frame fed back, and
// Y); HC: x <- sigmoid(LN1(h1)) * LN2(h2) + (1 - sigmoid) * x. A block
// computes the rows b = rank + CLW k of its cluster rank and stores each
// into the copies of all CLW blocks of its cluster. A warp loads its row
// (lane l holds columns l + 32i), takes the statistics, stages the
// normalised row z = (h - mean) * rsqrt(var + eps) in shared memory (zs,
// ldh floats a warp), and then applies the norms' parameters (lnb, staged
// before the barrier), gates and activations in one rolled loop: the
// phase runs once a layer, and its code is kept short, because fetching
// long unrolled code is what paced it.
template <int PL>  // columns a lane holds: 16 (C, width <= 512), 8 (HC,
                   // C <= 256); wider rows take normalise_wide
__device__ __forceinline__ void load_row(const float* h, int W,
                                         float (&a)[PL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int c = lane + 32 * i;
    a[i] = c < W ? __ldcg(h + c) : 0.f;
  }
}

// z_j[c] = (a[j][c] - mean_j) * rsqrt(var_j + eps) of N rows of W values
// held as a[j][i] (0 past W), the biased variance; row j into z + j * W.
// The N chains run side by side.
template <int N, int PL>
__device__ __forceinline__ void normalise(const float (&a)[N][PL], int W,
                                          float eps, float* z) {
  const int lane = threadIdx.x & 31;
  float s[N], mean[N], q[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[j] = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) s[j] += a[j][i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mean[j] = s[j] / (float)W;
    q[j] = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i)
      if (lane + 32 * i < W) q[j] += (a[j][i] - mean[j]) * (a[j][i] - mean[j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) q[j] += __shfl_xor_sync(0xffffffffu, q[j], o);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float rs = rsqrtf(q[j] / (float)W + eps);
#pragma unroll
    for (int i = 0; i < PL; ++i)
      if (lane + 32 * i < W)
        z[j * W + lane + 32 * i] = (a[j][i] - mean[j]) * rs;
  }
}

// normalise for rows wider than a lane's registers hold (C > 512, HC >
// 256): the same sums in the same order, the values read from h (N rows of
// W at a pitch of W) once for each pass.
template <int N>
__device__ __noinline__ void normalise_wide(const float* h, int W, float eps,
                                           float* z) {
  const int lane = threadIdx.x & 31;
  float s[N], mean[N], q[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[j] = 0.f;
    for (int c = lane; c < W; c += 32) s[j] += __ldcg(h + j * W + c);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    mean[j] = s[j] / (float)W;
    q[j] = 0.f;
    for (int c = lane; c < W; c += 32) {
      const float v = __ldcg(h + j * W + c) - mean[j];
      q[j] += v * v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) q[j] += __shfl_xor_sync(0xffffffffu, q[j], o);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float rs = rsqrtf(q[j] / (float)W + eps);
    for (int c = lane; c < W; c += 32)
      z[j * W + c] = (__ldcg(h + j * W + c) - mean[j]) * rs;
  }
}

// Column c of a row's output from its normalised row z: HC, the gate over
// the residual x; C, the norm's affine map and the activation (the last
// layer's sigmoid). apply_row: a row's into each of the ND copies dst, one
// warp, and Y from the row's owner block.
__device__ __forceinline__ float apply1(const Args& p, const Layer& L,
                                       const float* z, const float* lnb,
                                       const float* x, bool last, int c) {
  const int W = L.cout;
  float o;
  if (L.kind == 1) {
    const float gt = sigmoidf(z[c] * lnb[c] + lnb[W + c]);
    const float v2 = z[W + c] * lnb[2 * W + c] + lnb[3 * W + c];
    o = gt * v2 + (1.f - gt) * x[c];
  } else {
    o = z[c] * lnb[c] + lnb[p.cmo + c];
    if (L.act == 1) o = fmaxf(o, 0.f);
#pragma unroll 1
    for (int s = (L.act == 2) + last; s > 0; --s) o = sigmoidf(o);
  }
  return o;
}

template <int ND>
__device__ __forceinline__ void apply_row(const Args& p, const Layer& L,
                                          const float* z, const float* lnb,
                                          const float* x,
                                          float* const (&dst)[ND], bool last,
                                          int t, int b) {
  const int lane = threadIdx.x & 31;
  const bool own = last && b % gridDim.x == blockIdx.x;
#pragma unroll 2
  for (int c = lane; c < L.cout; c += 32) {
    const float o = apply1(p, L, z, lnb, x, last, c);
#pragma unroll
    for (int q = 0; q < ND; ++q) dst[q][c] = o;
    if (own) p.y[((size_t)b * p.T + t) * p.n_mels + c] = o;
  }
}

template <bool GEN, int CLW>
__device__ void post(const Args& p, const Layer& L, const float* hb,
                     const float* lnb, float* zs, bool last, int t,
                     float* xs, float* xg) {
  const int warp = threadIdx.x >> 5;
  const int rank = (int)cg::this_cluster().block_rank();
  const bool hc = L.kind == 1;
  const int W = L.cout;  // output columns (HC: C, of 2C pre-norm ones)
  float* z = zs + (size_t)warp * p.ldh;
  for (int k = warp; rank + CLW * k < p.B; k += NW) {
    const int b = rank + CLW * k;
    const float* hr = hb + (size_t)b * p.ldh;
    if (hc && (!GEN || W <= 32 * 8)) {  // the gate's half and the other
      float h[2][8];
      load_row<8>(hr, W, h[0]);
      load_row<8>(hr + W, W, h[1]);
      normalise<2, 8>(h, W, p.eps, z);
    } else if (!hc && (!GEN || W <= 32 * 16)) {
      float h[1][16];
      load_row<16>(hr, W, h[0]);
      normalise<1, 16>(h, W, p.eps, z);
    } else if (hc) {
      normalise_wide<2>(hr, W, p.eps, z);
    } else {
      normalise_wide<1>(hr, W, p.eps, z);
    }
    __syncwarp();
    float* dst[CLW];
#pragma unroll
    for (int q = 0; q < CLW; ++q) dst[q] = xrow_in(p, xs, q, b);
    // this block's copy holds the residual
    apply_row(p, L, z, lnb, xrow(p, xs, xg, b), dst, last, t, b);
    __syncwarp();
  }
}

// The flagged exchange's norms, in every block for every row, into its
// own copy: the block's threads gather the rows (gather_rows) into the
// staging zs (a row at a pitch of ldh), one warp a row takes post's
// statistics in place (the same lane order, so the same bits as post and in
// every block), and the threads apply the norms' parameters, gates and
// activations element by element (apply1); the row's owner block writes Y.
// Every row lies in shared memory and fits a lane's registers (not GEN), and
// the staging holds every row. (Each warp taking a row's statistics itself
// and applying its own columns from registers, with no staged z and one
// barrier fewer, was slower: PERF.md.)
template <bool STAMP>
__device__ void post_flag(const Args& p, const Layer& L, const uint2* hw,
                          unsigned e, const float* lnb, float* zs, bool last,
                          int t, float* xs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool hc = L.kind == 1;
  const int W = L.cout;
  gather_rows(hw, p.ldx, p.B, hc ? 2 * W : W, e, zs, p.ldh);
  sm90::cp_async_wait_all();  // lnb
  __syncthreads();
  Stamps<STAMP>::mark2(PH_PRODUCT, PH_EXCHANGE);
  for (int b = warp; b < p.B; b += NW) {
    float* z = zs + (size_t)b * p.ldh;
    if (hc) {
      float h[2][8];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          h[j][i] = lane + 32 * i < W ? z[j * W + lane + 32 * i] : 0.f;
      __syncwarp();
      normalise<2, 8>(h, W, p.eps, z);
    } else {
      float h[1][16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        h[0][i] = lane + 32 * i < W ? z[lane + 32 * i] : 0.f;
      __syncwarp();
      normalise<1, 16>(h, W, p.eps, z);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.B * W; i += NT) {
    const int b = i / W, c = i % W;
    float* x = xs + (size_t)b * p.xw;
    const float o = apply1(p, L, zs + (size_t)b * p.ldh, lnb, x, last, c);
    x[c] = o;
    if (last && b % gridDim.x == blockIdx.x)
      p.y[((size_t)b * p.T + t) * p.n_mels + c] = o;
  }
}

// Every row's attention, one warp a row, in every block (attention_split:
// in the wide kernel's clusters of CL_WIDE, a cluster rank's rows only):
// scores of the <= win unmasked keys, softmax (the masked keys'
// exp(NEG_INF - max) is exactly 0), new cursor = first argmax, ctx = a.V;
// the row [q] becomes [ctx; q]. The row's owner block writes column t of
// A. A config whose
// window is at most ROW_WIN keys with d <= 256 (32 * FCH) takes
// attention_row, straight-line code with all the keys' features loaded at
// once; any other takes attention_walk, which computes the same sums in the
// same order.

// One row: lane l holds features l + 32i; the keys are loaded at once, then
// the values; q is read from x and [ctx; q] stored into each of the ND
// copies dst. Returns the cursor's offset in the window.
template <int ND>
__device__ __forceinline__ int attention_row(const Args& p, int t,
                                             const float* x,
                                             float* const (&dst)[ND], int b,
                                             int pv, int nw) {
  const int lane = threadIdx.x & 31, d = p.d;
  float q[FCH], kk[ROW_WIN][FCH];
  const size_t row0 = ((size_t)b * p.N + pv) * d;
#pragma unroll
  for (int i = 0; i < FCH; ++i) {
    const int c = lane + 32 * i;
    q[i] = c >= d ? 0.f
           : b < p.rows_sh ? x[c]
                           : *static_cast<const volatile float*>(x + c);
#pragma unroll
    for (int w = 0; w < ROW_WIN; ++w)
      kk[w][i] = c < d && w < nw ? __ldg(p.kt + row0 + (size_t)w * d + c)
                                 : 0.f;
  }
  float s[ROW_WIN];
  float m = -INFINITY;
#pragma unroll
  for (int w = 0; w < ROW_WIN; ++w) {
    if (w < nw) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < FCH; ++i)
        if (lane + 32 * i < d) part = fmaf(kk[w][i], q[i], part);
      s[w] = warp_sum(part) * p.scale;
      m = fmaxf(m, s[w]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < ROW_WIN; ++w)
    if (w < nw) {
      s[w] = expf(s[w] - m);
      sum += s[w];
    }
  float best = -1.f;
  int bi = 0;
#pragma unroll
  for (int w = 0; w < ROW_WIN; ++w)
    if (w < nw) {
      s[w] = s[w] / sum;
      if (s[w] > best) {  // strict: the first maximum wins
        best = s[w];
        bi = w;
      }
    }
#pragma unroll
  for (int i = 0; i < FCH; ++i) {
    const int c = lane + 32 * i;
    if (c < d) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < ROW_WIN; ++w)
        if (w < nw)
          acc = fmaf(s[w], __ldg(p.v + row0 + (size_t)w * d + c), acc);
#pragma unroll
      for (int u = 0; u < ND; ++u) {
        dst[u][d + c] = q[i];
        dst[u][c] = acc;
      }
    }
  }
  if (b % gridDim.x == blockIdx.x) {
    float* acol = p.a + (size_t)b * p.N * p.T + t;
    for (int n = lane; n < p.N; n += 32) {
      const int w = n - pv;
      float v = 0.f;
#pragma unroll
      for (int u = 0; u < ROW_WIN; ++u)
        if (u < nw && u == w) v = s[u];
      acol[(size_t)n * p.T] = v;
    }
  }
  return bi;
}

// The scores of keys [w0, w0 + MAX_WIN) of a window (those < nw), from the
// key rows at kb and q: lane l sums features l + 32i in order (in chunks of
// 32 * FCH), the 32 lane sums added as warp_sum adds them.
__device__ __forceinline__ void scores(const Args& p, const float* q,
                                       const float* kb, int w0, int nw,
                                       float (&s)[MAX_WIN]) {
  const int lane = threadIdx.x & 31, d = p.d;
  float part[MAX_WIN];
#pragma unroll
  for (int w = 0; w < MAX_WIN; ++w) part[w] = 0.f;
  for (int c0 = 0; c0 < d; c0 += 32 * FCH) {
#pragma unroll
    for (int i = 0; i < FCH; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c >= d) continue;
      const float qv = q[c];
#pragma unroll
      for (int w = 0; w < MAX_WIN; ++w)
        if (w0 + w < nw)
          part[w] = fmaf(__ldg(kb + (size_t)(w0 + w) * d + c), qv, part[w]);
    }
  }
#pragma unroll
  for (int w = 0; w < MAX_WIN; ++w)
    if (w0 + w < nw) s[w] = warp_sum(part[w]) * p.scale;
}

// Any window and any d: q moves to the row's second half first and is read
// from there, ctx is summed into the first; the window is walked in
// register chunks of MAX_WIN keys three times (the largest score; the sum
// of the exponentials in key order; the probabilities, the argmax (strict,
// so the first maximum wins across chunks too), ctx and A), the scores
// recomputed in each (the same arithmetic, so the same bits).
__device__ __forceinline__ int attention_walk(const Args& p, int t, float* x,
                                              int b, int pv, int nw) {
  const int lane = threadIdx.x & 31, d = p.d;
  float* q = x + d;
  for (int c = lane; c < d; c += 32)
    q[c] = b < p.rows_sh ? x[c] : *static_cast<volatile float*>(x + c);
  const float* kb = p.kt + ((size_t)b * p.N + pv) * d;
  const float* vb = p.v + ((size_t)b * p.N + pv) * d;
  float s[MAX_WIN];
  float m = -INFINITY;
  for (int w0 = 0; w0 < nw; w0 += MAX_WIN) {
    scores(p, q, kb, w0, nw, s);
#pragma unroll
    for (int w = 0; w < MAX_WIN; ++w)
      if (w0 + w < nw) m = fmaxf(m, s[w]);
  }
  float sum = 0.f;
  for (int w0 = 0; w0 < nw; w0 += MAX_WIN) {
    scores(p, q, kb, w0, nw, s);
#pragma unroll
    for (int w = 0; w < MAX_WIN; ++w)
      if (w0 + w < nw) sum += expf(s[w] - m);
  }
  const bool own = b % gridDim.x == blockIdx.x;
  float* acol = p.a + (size_t)b * p.N * p.T + t;
  if (own)
    for (int n = lane; n < p.N; n += 32)
      if (n < pv || n >= pv + nw) acol[(size_t)n * p.T] = 0.f;
  float best = -1.f;
  int bi = 0;
  for (int w0 = 0; w0 < nw; w0 += MAX_WIN) {
    scores(p, q, kb, w0, nw, s);
    float mine = 0.f;  // lane w's probability, for A
#pragma unroll
    for (int w = 0; w < MAX_WIN; ++w)
      if (w0 + w < nw) {
        s[w] = expf(s[w] - m) / sum;
        if (s[w] > best) {
          best = s[w];
          bi = w0 + w;
        }
        if (w == lane) mine = s[w];
      }
    for (int c = lane; c < d; c += 32) {
      float acc = w0 ? x[c] : 0.f;
#pragma unroll
      for (int w = 0; w < MAX_WIN; ++w)
        if (w0 + w < nw)
          acc = fmaf(s[w], __ldg(vb + (size_t)(w0 + w) * d + c), acc);
      x[c] = acc;
    }
    if (own && lane < MAX_WIN && w0 + lane < nw)
      acol[(size_t)(pv + w0 + lane) * p.T] = mine;
  }
  return bi;
}

template <bool GEN>
__device__ void attention(const Args& p, int t, float* xs, float* xg,
                          int* prev) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // one branch a launch, outside the rows' loop, and only in the general
  // kernel: the walk stays off the common case's path (a call there, or a
  // branch a row, cost it ~2 %)
  if (!GEN || (p.win <= ROW_WIN && p.d <= 32 * FCH)) {
    for (int b = warp; b < p.B; b += NW) {
      float* const x[1] = {xrow(p, xs, xg, b)};
      const int pv = prev[b];
      const int bi =
          attention_row(p, t, x[0], x, b, pv, min(p.win, p.N - pv));
      __syncwarp();
      if (lane == 0) prev[b] = pv + bi;
    }
  } else {
    for (int b = warp; b < p.B; b += NW) {
      float* x = xrow(p, xs, xg, b);
      const int pv = prev[b];
      const int bi = attention_walk(p, t, x, b, pv, min(p.win, p.N - pv));
      __syncwarp();
      if (lane == 0) prev[b] = pv + bi;
    }
  }
}

// The wide kernel's attention (every row in shared memory, attention_row):
// the block of cluster rank r computes the rows whose norms it computes,
// b = r + CLW k (post), one warp a row, and stores each row's [ctx; q] into
// the copies of every block of its cluster; a cluster barrier after it
// closes the phase. Rank r always computes the same rows, so row b's cursor
// lives in that block's prev alone; every cluster computes the same bits,
// so the clusters' copies agree. The owner of A's row b (b % blocks) has
// rank b % CLW, since the blocks are whole clusters. At B = 72 in clusters
// of 8 a block's 9 rows are one round of its warps, where every block's 72
// rows took five, each row's keys and values read by all 120 blocks at once.
template <int CLW>
__device__ void attention_split(const Args& p, int t, float* xs, int* prev) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = (int)cg::this_cluster().block_rank();
  for (int k = warp; rank + CLW * k < p.B; k += NW) {
    const int b = rank + CLW * k;
    float* dst[CLW];
#pragma unroll
    for (int q = 0; q < CLW; ++q) dst[q] = xrow_in(p, xs, q, b);
    const int pv = prev[b];
    const int bi = attention_row(p, t, xs + (size_t)b * p.xw, dst, b, pv,
                                 min(p.win, p.N - pv));
    __syncwarp();
    if (lane == 0) prev[b] = pv + bi;
  }
}

// The block's slice of a resident layer's slot(s) into shared memory, its
// rows packed at a pitch of the layer's depth, 8 bytes a copy.
__device__ void load_slice(const Layer& L, int c0, int n, char* smem) {
  const int esz = L.wkind == WK_F32 ? 4 : 2;
  const int row_bytes = (L.kind == 1 ? 3 : 1) * L.kp * esz;
  const int units = row_bytes / 8;
  for (int half = 0; half < (L.wkind == WK_SPLIT ? 2 : 1); ++half) {
    const char* src = static_cast<const char*>(half ? L.wl : L.w)
                      + (size_t)c0 * L.ldw * esz;
    char* dst = smem + L.woff + (size_t)half * L.nmax * row_bytes;
    for (int i = threadIdx.x; i < n * units; i += NT) {
      const int j = i / units, u = i % units;
      *reinterpret_cast<uint2*>(dst + (size_t)j * row_bytes + 8 * u) =
          *reinterpret_cast<const uint2*>(src + (size_t)j * L.ldw * esz
                                          + 8 * u);
    }
  }
}

__device__ __forceinline__ void columns(const Layer& L, int& c0, int& n) {
  const int W = L.kind == 1 ? 2 * L.cout : L.cout;
  c0 = (int)((long long)blockIdx.x * W / gridDim.x);
  n = (int)((long long)(blockIdx.x + 1) * W / gridDim.x) - c0;
}

// A staged layer's slice into the staging slot (F.woff), laid out as
// load_slice lays a resident one, by the copy engine (bulk copies, one a
// slice row, or one for the slice where its rows are contiguous: an HC
// layer's), counted on the mbarrier bar; thread 0 issues them. The grid
// exchange's layer before F in the cycle of staged layers issues it after
// its product, once the slot's last reader is done, and its threads wait
// on bar before its cluster barrier: the copy runs under that layer's
// combine, grid barrier and norms. (cp.async by the block's threads cost
// more than the copy saved: their issue, and thread 0's release at the
// grid barrier waiting for its copies.)
__device__ __forceinline__ void fetch_slice(const Layer& F, char* smem,
                                            uint64_t* bar) {
  int c0, n;
  columns(F, c0, n);
  const int esz = F.wkind == WK_F32 ? 4 : 2;
  const int row_bytes = (F.kind == 1 ? 3 : 1) * F.kp * esz;
  const size_t pitch = (size_t)F.ldw * esz;
  const int halves = F.wkind == WK_SPLIT ? 2 : 1;
  sm90::fence_proxy_async();  // after the generic proxy's reads and writes
  sm90::mbar_expect_tx(bar, (uint32_t)(halves * n * row_bytes));
  for (int half = 0; half < halves; ++half) {
    const char* src =
        static_cast<const char*>(half ? F.wl : F.w) + (size_t)c0 * pitch;
    const uint32_t dst =
        sm90::smem_u32(smem + F.woff + (size_t)half * F.nmax * row_bytes);
    if (pitch == (size_t)row_bytes)
      sm90::bulk_copy(dst, src, (uint32_t)(n * row_bytes), bar);
    else
      for (int j = 0; j < n; ++j)
        sm90::bulk_copy(dst + j * row_bytes, src + j * pitch,
                        (uint32_t)row_bytes, bar);
  }
}

// The layer's product in its operand kind and task shape: wide tasks only
// in the wide kernel (the host's plan sets L.rg there).
template <bool WIDE>
__device__ __forceinline__ void layer_product(const Args& p, const Layer& L,
                                              int c0, int n, float* xs,
                                              float* xg, float* part,
                                              const char* smem) {
  if (WIDE && L.rg == RG_WIDE) {
    if (L.wkind == WK_F32)
      product_wide<WK_F32>(p, L, c0, n, xs, part, smem);
    else
      product_wide<WK_BF16>(p, L, c0, n, xs, part, smem);
  } else if (L.wkind == WK_F32) {
    product<WK_F32>(p, L, c0, n, xs, xg, part, smem);
  } else if (L.wkind == WK_BF16) {
    product<WK_BF16>(p, L, c0, n, xs, xg, part, smem);
  } else {
    product<WK_SPLIT>(p, L, c0, n, xs, xg, part, smem);
  }
}

// GEN: the general kernel, for configs past the common case (a window of
// more than ROW_WIN keys, d > 256, a row wider than a lane's registers,
// norm parameters off 16 bytes); the common kernel compiles none of it.
// FLAG: the flagged exchange (common configs only); the grid exchange's
// kernels compile none of it. WIDE: the grid exchange's wide kernel (common
// configs only, every row and slice in shared memory): wide product tasks
// and the staged slices; the others compile none of it. CLW: the blocks of
// a cluster, which split the grid exchange's norm rows (and, in the wide
// kernel at CL_WIDE, its attention rows: ATTN_SPLIT). STAMP: the stamped
// twin, which times its phases (Stamps) into p.stamps; every instantiation
// has one, launched only while the host records spans.
template <bool GEN, bool FLAG, bool WIDE, int CLW, bool STAMP>
__global__ void __launch_bounds__(NT, 1)
decode_kernel(const __grid_constant__ Args p,
              const __grid_constant__ Program prog) {
  // the attention rows split over the cluster's ranks (attention_split;
  // attn_split in ops/decode.py): in clusters of 2 a rank's 36 rows at
  // B = 72 took three rounds of its warps, and K1 did not gain (PERF.md)
  constexpr bool ATTN_SPLIT = WIDE && CLW == CL_WIDE;
  Stamps<STAMP>::start();
  extern __shared__ __align__(16) char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* part = reinterpret_cast<float*>(smem + p.part_off);
  int* prev = reinterpret_cast<int*>(smem + p.prev_off);
  float* lnb = reinterpret_cast<float*>(smem + p.ln_off);
  float* zs = reinterpret_cast<float*>(smem + p.z_off);
  float* xg = p.spill + (size_t)blockIdx.x * p.spill_floats;
  float* ring = p.ring + (size_t)blockIdx.x * p.ring_floats;
  uint64_t* sbar = reinterpret_cast<uint64_t*>(smem + p.sbar_off);  // WIDE
  const int nl = prog.n_enc + prog.n_dec;

  // zero start: the first input frame, the cursors and the ring (the
  // causal left padding's products are exactly 0)
  for (int i = threadIdx.x; i < p.rows_sh * p.xw; i += NT) xs[i] = 0.f;
  for (int i = threadIdx.x; i < p.spill_floats; i += NT) xg[i] = 0.f;
  for (int i = threadIdx.x; i < p.ring_floats; i += NT) ring[i] = 0.f;
  for (int i = threadIdx.x; i < p.B; i += NT) prev[i] = 0;
  // the resident slices, and the first staged one into the staging slot
  if (WIDE && p.stage0 >= 0 && threadIdx.x == 0) {
    sm90::mbar_init(sbar, 1);
    sm90::mbar_fence_init();
  }
  for (int li = 0; li < nl; ++li) {
    const Layer& L = prog.l[li];
    if (L.woff >= 0 && (!WIDE || L.fetch < 0 || li == p.stage0)) {
      int c0, n;
      columns(L, c0, n);
      load_slice(L, c0, n, smem);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every member runs before any writes into its copy
  Stamps<STAMP>::mark(PH_PROLOGUE);

  unsigned target = 0;
  int parity = 0;
  uint32_t sphase = 0;  // the staging mbarrier's phase
  for (int t = 0; t < p.T; ++t) {
    for (int li = 0; li < nl; ++li) {
      if (li == prog.n_enc) {  // AudioEnc's output q -> [ctx; q]
        if constexpr (ATTN_SPLIT) {
          attention_split<CLW>(p, t, xs, prev);
          cluster.sync();  // every member's copy holds every row's [ctx; q]
        } else {
          attention<GEN>(p, t, xs, xg, prev);
          __syncthreads();
        }
        Stamps<STAMP>::mark(PH_ATTENTION);
      }
      const Layer& L = prog.l[li];
      int c0, n;
      columns(L, c0, n);
      // the norms' parameters (HC: 4 x C; C: gamma, beta at a pitch of
      // cmo) into lnb, under the product
      // (an odd cmo leaves C layers' rows unaligned: plain loads then)
      const int nln = L.kind == 1 ? 4 * L.cout : 2 * p.cmo;
      if (!GEN || L.lnv)
        for (int i = 4 * threadIdx.x; i < nln; i += 4 * NT)
          sm90::cp_async16(sm90::smem_u32(lnb + i), L.ln + i, 16);
      else
        for (int i = threadIdx.x; i < nln; i += NT) lnb[i] = L.ln[i];
      const Addends first =
          threadIdx.x < p.B * n
              ? addends(p, L, t, c0, n, threadIdx.x, ring) : Addends{};
      layer_product<WIDE>(p, L, c0, n, xs, xg, part, smem);
      __syncthreads();
      // the next staged layer's slice, under the exchange (the slot's
      // readers are done)
      if (WIDE && L.fetch >= 0 && threadIdx.x == 0)
        fetch_slice(prog.l[L.fetch], smem, sbar);
      if constexpr (FLAG) {
        uint2* hw = p.words + (size_t)parity * p.B * p.ldx;
        const unsigned e = p.epoch0 + (unsigned)(t * nl + li);
        combine<true>(p, L, t, c0, n, part, ring, nullptr, hw, e, first);
        Stamps<STAMP>::note();
        post_flag<STAMP>(p, L, hw, e, lnb, zs, li == nl - 1, t, xs);
        __syncthreads();  // this block's copy holds the layer's output
        Stamps<STAMP>::mark(PH_NORM);
      } else {
        float* hb = p.hbuf + (size_t)parity * p.B * p.ldh;
        combine<false>(p, L, t, c0, n, part, ring, hb, nullptr, 0, first);
        sm90::cp_async_wait_all();  // lnb
        grid_sync<STAMP>(p.bar, target);
        Stamps<STAMP>::mark(PH_EXCHANGE);
        post<GEN, CLW>(p, L, hb, lnb, zs, li == nl - 1, t, xs, xg);
        Stamps<STAMP>::note();
        if (WIDE && L.fetch >= 0) {  // the slot holds the next staged slice
          sm90::mbar_wait(sbar, sphase);
          sphase ^= 1;
        }
        cluster.sync();  // every member's copy holds the layer's output
        Stamps<STAMP>::mark2(PH_NORM, PH_EXCHANGE);
      }
      parity ^= 1;
    }
  }
  Stamps<STAMP>::finish(p.stamps);
}

// The barriers of a decode alone, for the floor they set: n grid barriers
// over the launch's blocks, nothing else.
__global__ void __launch_bounds__(NT, 1) barrier_kernel(unsigned* bar, int n) {
  unsigned target = 0;
  for (int i = 0; i < n; ++i) grid_sync<false>(bar, target);
}

// The flagged exchanges of a B = 1 decode alone, for the floor they set: n
// exchanges of an HC layer's pre-norm row (2 x C words) over the launch's
// blocks, as the decode kernel runs them (each block publishes its columns,
// then gathers the whole row into shared memory), nothing else (words:
// zeroed).
__global__ void __launch_bounds__(NT, 1) exchange_kernel(uint2* words, int n,
                                                         int C) {
  extern __shared__ float zrow[];
  const int c0 = (int)((long long)blockIdx.x * 2 * C / gridDim.x);
  const int c1 = (int)((long long)(blockIdx.x + 1) * 2 * C / gridDim.x);
  for (int i = 0; i < n; ++i) {
    uint2* hw = words + (size_t)(i & 1) * 2 * C;
    for (int c = c0 + threadIdx.x; c < c1; c += NT)
      publish(hw + c, (float)c, (unsigned)i + 1);
    gather_rows(hw, 2 * C, 1, 2 * C, (unsigned)i + 1, zrow, 2 * C);
    __syncthreads();
  }
}

typedef void (*Kernel)(Args, Program);

// The instantiation a launch takes (the flagged, general, wide or common
// kernel) in clusters of cl blocks, or null where it is not built at cl;
// with `stamp`, its stamped twin.
template <bool S>
Kernel instance(bool flag, bool general, bool wide, int cl) {
  if (flag)
    return cl == CL ? decode_kernel<false, true, false, CL, S> : nullptr;
  if (general)
    return cl == CL ? decode_kernel<true, false, false, CL, S> : nullptr;
  if (wide)
    return cl == CL_WIDE ? decode_kernel<false, false, true, CL_WIDE, S>
         : cl == CL ? decode_kernel<false, false, true, CL, S> : nullptr;
  return cl == CL ? decode_kernel<false, false, false, CL, S> : nullptr;
}

Kernel decode_instance(bool flag, bool general, bool wide, int cl,
                       bool stamp) {
  return stamp ? instance<true>(flag, general, wide, cl)
               : instance<false>(flag, general, wide, cl);
}

cudaError_t set_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// A cooperative launch of `blocks` blocks in clusters of cl.
struct LaunchConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  LaunchConfig(int blocks, int smem, cudaStream_t stream, int cl) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
  }
};

}  // namespace

// The most blocks of `smem` dynamic bytes, in clusters of `cluster`, that
// can be co-resident on the current device (the cooperative launch's limit)
// into *blocks, and the number of SMs into *sms: the query of the
// instantiation launched at that width (the common kernel at CL, the wide
// one wider; every instantiation has the same threads, register cap and
// shared memory).
extern "C" int dctts_decode_coresident(int smem, int cluster, int* blocks,
                                       int* sms) {
  const Kernel kernel =
      decode_instance(false, false, cluster != CL, cluster, false);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, clusters = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  LaunchConfig lc(*sms / cluster * cluster, smem, 0, cluster);
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &lc.cfg);
  if (e != cudaSuccess) return (int)e;
  *blocks = clusters * cluster;
  return 0;
}

// layer_ints: LAYER_INTS a layer (kind, cin, cout, rate, act, ring_off,
// wkind, ldw, woff, nmax, kp, lnv, fetch, rg); layer_ptrs: LAYER_PTRS a
// layer (w, wl, bias, ln); AudioEnc's layers first. The plan's sizes and
// offsets come from ops/decode.py:decode_plan. flag 0: the grid exchange
// (hbuf: 2 x B x ldh floats; bar: a zeroed counter); flag 1: the flagged
// exchange (hbuf: 2 x B x ldx zeroed 8-byte words; bar unused; epochs
// epoch0 .. epoch0 + T x layers - 1), for a config of the common kernel
// whose rows all lie in shared memory. `blocks`: whole clusters of
// `cluster`, a width the instantiation the launch takes is built at. Staged
// slices (fetch, stage0: the
// first staged layer, or -1; sbar_off: the slot's mbarrier, 8 bytes) and
// wide tasks (rg RG_WIDE, every row and slice in shared memory) only on
// the grid exchange's common kernel; a staged slice's rows and pitch are
// 16-byte multiples, on 16-byte boundaries. stamps: null, or blocks x
// STAMP_WORDS 64-bit words that the stamped twin of the launch's
// instantiation fills with each block's record (its static shared memory
// takes sizeof(StampRecord) bytes beside smem).
extern "C" int dctts_decode(const float* kt, const float* v, float* y,
                            float* a, void* hbuf, float* ring, float* spill,
                            unsigned* bar, const int* layer_ints,
                            const void* const* layer_ptrs, int n_enc,
                            int n_dec, int B, int N, int d, int n_mels, int T,
                            int win, float eps, int cmo, int xw, int ldh,
                            int rows_sh, int ring_floats, int spill_floats,
                            int part_off, int prev_off, int ln_off,
                            int z_off, int nv_max, int smem, int blocks,
                            int cluster, int flag, int ldx, int stage0,
                            int sbar_off, unsigned epoch0, void* stamps,
                            void* stream) {
  if (n_enc + n_dec > MAX_LAYERS || win < 1 || B < 1 || cluster < 1 ||
      blocks < cluster || blocks % cluster || xw % 4 ||
      (flag && (rows_sh < B || ldx < ldh)))
    return (int)cudaErrorInvalidValue;
  Program prog;
  prog.n_enc = n_enc;
  prog.n_dec = n_dec;
  bool general = win > ROW_WIN || d > 32 * FCH;
  for (int i = 0; i < MAX_LAYERS; ++i) prog.l[i] = Layer{};
  for (int i = 0; i < n_enc + n_dec; ++i) {
    const int* f = layer_ints + LAYER_INTS * i;
    const void* const* q = layer_ptrs + LAYER_PTRS * i;
    Layer& L = prog.l[i];
    L.kind = f[0]; L.cin = f[1]; L.cout = f[2]; L.rate = f[3]; L.act = f[4];
    L.ring_off = f[5]; L.wkind = f[6]; L.ldw = f[7]; L.woff = f[8];
    L.nmax = f[9]; L.kp = f[10]; L.lnv = f[11]; L.fetch = f[12]; L.rg = f[13];
    L.w = q[0]; L.wl = q[1];
    L.bias = static_cast<const float*>(q[2]);
    L.ln = static_cast<const float*>(q[3]);
    if (L.wkind < WK_F32 || L.wkind > WK_SPLIT || !L.w ||
        (L.wkind == WK_SPLIT && !L.wl) || L.ldw % 4 || L.kp % 4 ||
        (L.lnv && reinterpret_cast<uintptr_t>(L.ln) % 16))
      return (int)cudaErrorInvalidValue;
    general = general || !L.lnv || L.cout > 32 * (L.kind == 1 ? 8 : 16);
  }
  bool wide_kernel = false;  // wide tasks or staged slices
  for (int i = 0; i < n_enc + n_dec; ++i) {
    const Layer& L = prog.l[i];
    const bool wide = L.rg == RG_WIDE, staged = L.fetch >= 0;
    const int esz = L.wkind == WK_F32 ? 4 : 2;
    wide_kernel = wide_kernel || wide || staged;
    if (staged && ((L.kind == 1 ? 3 : 1) * L.kp * esz % 16 ||
                   L.ldw * esz % 16 ||
                   reinterpret_cast<uintptr_t>(L.w) % 16 ||
                   reinterpret_cast<uintptr_t>(L.wl) % 16))
      return (int)cudaErrorInvalidValue;
    if ((L.rg != RG && !wide) ||
        (wide && (flag || general || rows_sh < B || L.wkind == WK_SPLIT ||
                  L.woff < 0)) ||
        (staged && (flag || general || L.fetch >= n_enc + n_dec ||
                    L.woff < 0 || prog.l[L.fetch].woff != L.woff)))
      return (int)cudaErrorInvalidValue;
  }
  if (stage0 >= n_enc + n_dec ||
      (stage0 >= 0 && (prog.l[stage0].fetch < 0 || sbar_off < 0 ||
                       sbar_off % 8 || sbar_off + 8 > smem)))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.kt = kt; p.v = v; p.y = y; p.a = a;
  p.hbuf = flag ? nullptr : static_cast<float*>(hbuf);
  p.words = flag ? static_cast<uint2*>(hbuf) : nullptr;
  p.ring = ring; p.spill = spill; p.bar = bar;
  p.B = B; p.N = N; p.d = d; p.n_mels = n_mels; p.T = T; p.win = win;
  p.cmo = cmo; p.xw = xw; p.ldh = ldh;
  p.rows_sh = rows_sh; p.ring_floats = ring_floats;
  p.spill_floats = spill_floats; p.part_off = part_off;
  p.prev_off = prev_off; p.ln_off = ln_off; p.z_off = z_off;
  p.nv_max = nv_max; p.ldx = ldx; p.stage0 = stage0;
  p.sbar_off = stage0 >= 0 ? sbar_off : 0;
  p.epoch0 = epoch0;
  p.eps = eps;
  p.scale = (float)(1.0 / sqrt((double)d));
  p.stamps = static_cast<uint64_t*>(stamps);
  if (flag && general) return (int)cudaErrorInvalidValue;
  const Kernel kernel =
      decode_instance(flag, general, wide_kernel, cluster, stamps != nullptr);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  LaunchConfig lc(blocks, smem, (cudaStream_t)stream, cluster);
  e = cudaLaunchKernelEx(&lc.cfg, kernel, p, prog);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// n flagged exchanges of a 2 x C word row over `blocks` co-resident blocks
// of NT threads, as the decode kernel runs them at B = 1 (words: 4 x C
// zeroed 8-byte words).
extern "C" int dctts_decode_exchanges(void* words, int n, int C, int blocks,
                                      void* stream) {
  void* args[] = {&words, &n, &C};
  cudaError_t e = cudaFuncSetAttribute(
      exchange_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      8 * C);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel((const void*)exchange_kernel, dim3(blocks),
                                  dim3(NT), args, 8 * C,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// n grid barriers over `blocks` co-resident blocks of NT threads, as the
// decode kernel runs them (bar: a zeroed counter).
extern "C" int dctts_decode_barriers(unsigned* bar, int n, int blocks,
                                     void* stream) {
  void* args[] = {&bar, &n};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)barrier_kernel, dim3(blocks), dim3(NT), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
