// The pipelined bf16 GEMM core on the Hopper tensor cores, shared by K4's
// bf16 body (csrc/hc_vjp.cu), K3 (csrc/gl.cu) and X1's bf16 body
// (csrc/ct_fwd.cu X1Op): one block computes a
// 128 x 128 tile of out = A @ B with bf16 operands and float32 sums, or with
// three parts A_hi@B_hi + A_hi@B_lo + A_lo@B_hi (a bf16 hi/lo split of
// float32 operands).
//
//  - 384 threads: consumer warpgroups 0 and 1 (rows 0-63 and 64-127 of the
//    tile), producer warpgroup 2. setmaxnreg hands the producer's registers
//    to the consumers.
//  - The producer fills a ring of shared-memory stages, 192 KB in all (6
//    stages of one part, 3 of two), with 16-byte cp.async (src-size 0 is
//    zero fill), each stage's copies arriving on its `full` mbarrier; the
//    consumers release a stage on its `empty` mbarrier. Every wait traps
//    after 10 s (sm90::mbar_wait).
//  - A k-tile is 64 bf16 deep, one 128-byte swizzled row; a stage holds A's
//    parts then B's, 16 KB each. A consumer warpgroup runs 4 wgmma
//    m64n128k16 (12 with three parts) a k-tile, both operands read from
//    shared memory through descriptors, K-major or MN-major as the operation
//    declares (the transpose immediates), so no operand needs a transposed
//    copy in device memory.
//  - The tensor cores' float32 sums truncate over long depths, so every
//    PROMOTE k-tiles the accumulators are added into float32 register sums
//    and restarted. Within such a window one k-tile's group of products
//    stays in flight while the next is issued (wgmma.wait_group 1); the
//    groups drain only where the window ends.
//
// An operation Op supplies the tile's data and its epilogue:
//   Op::Args            the kernel's argument (by value)
//   Op::PARTS           1, or 2 for the three-product hi/lo form
//   Op::A_MN, Op::B_MN  operand layouts in shared memory (false: K-major)
//   Op::Shared          per-block shared state (e.g. a row table)
//   Op(const Args&)     the block's tile from blockIdx; sets nk (k-tiles) and
//                       skip (a tile with no work: zero_tile writes it)
//   init_shared(sh, tid), before the ring starts (all threads)
//   producer_init(sh, pt), load(sh, kt, a, b): producer thread pt in
//                       [0, 128) issues its cp.asyncs of k-tile kt into the
//                       stage whose A parts start at shared address a and B
//                       parts at b (lo parts TILE_BYTES after hi)
//   epilogue(sum, r, t): consumer lane with d[4i + 2h + e] at tile row r +
//                       8h, column 8i + 2t + e
// Layouts (TILE_BYTES per operand part):
//   K-major: row r (m or n) of 64 k at r*128, chunk c at c ^ (r % 8)
//            (wg::kmaj)
//   MN-major: k-row r of 64 m/n elements at blk*8192 + r*128, blk the block
//            of 64 along m/n, chunk c at c ^ (r % 8) (wg::mnmaj)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

namespace wg {

constexpr int BM = 128, BN = 128, BK = 64;  // block tile, k-tile (bf16)
constexpr int THREADS = 384;
constexpr int TILE_BYTES = BM * BK * 2;     // one part of one operand
constexpr int RING_BYTES = 12 * TILE_BYTES; // 192 KB
constexpr int PROMOTE = 2;                  // k-tiles between promotions
static_assert(BN * BK * 2 == TILE_BYTES, "A and B tiles are the same size");

template <class Op>
__host__ __device__ constexpr int stages() {
  return RING_BYTES / (2 * Op::PARTS * TILE_BYTES);
}

template <class Op>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (size_t)RING_BYTES + 2 * stages<Op>() * sizeof(uint64_t) +
         sizeof(typename Op::Shared);
}

// byte offset of 16-byte chunk c of row r in a K-major tile
__device__ __forceinline__ uint32_t kmaj(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// byte offset of 16-byte chunk j (elements 8j..8j+7 along m/n, j < 16) of
// k-row r in an MN-major tile
__device__ __forceinline__ uint32_t mnmaj(int r, int j) {
  return (uint32_t)((j >> 3) * (TILE_BYTES / 2) + kmaj(r, j & 7));
}

template <bool MN>
__device__ __forceinline__ uint64_t desc(uint32_t tile, int ks) {
  return MN ? sm90::desc_mn_sw128(tile + ks * 2048, TILE_BYTES / 2)
            : sm90::desc_sw128(tile + ks * 32);
}

template <class Op>
__global__ void __launch_bounds__(THREADS, 1) gemm(const typename Op::Args p) {
  constexpr int PARTS = Op::PARTS, STAGES = stages<Op>();
  constexpr int STAGE = 2 * PARTS * TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // the tiles start on 1024-byte boundaries of the shared window
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = (uint64_t*)(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  typename Op::Shared& sh = *(typename Op::Shared*)(empty + STAGES);
  const int tid = threadIdx.x;
  Op op(p);
  if (op.skip) {  // the whole block takes this branch or none of it does
    op.zero_tile(tid);
    return;
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 128);  // one cp.async arrival a producer
      sm90::mbar_init(&empty[s], 256); // one arrival a consumer thread
    }
    sm90::mbar_fence_init();
  }
  op.init_shared(sh, tid);
  __syncthreads();
  const int nk = op.nk;
  const uint32_t ring = sm90::smem_u32(smem);

  if (tid >= 256) {
    // ---------------- producer warpgroup: cp.async into the ring
    sm90::regs_dec<56>();
    op.producer_init(sh, tid - 256);
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) sm90::mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
      const uint32_t a = ring + s * STAGE;
      op.load(sh, kt, a, a + PARTS * TILE_BYTES);
      sm90::cp_async_arrive(&full[s]);
    }
    sm90::cp_async_wait_all();
  } else {
    // ---------------- consumer warpgroups: 64 rows x 128 columns each
    sm90::regs_inc<224>();
    const int wgi = tid >> 7, lane = tid & 31;
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
    // one group of products in flight within a promotion window: a stage
    // is released once the group that read it has completed
    int pending = -1;  // the stage of the group still in flight, or -1
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      sm90::mbar_wait(&full[s], (kt / STAGES) & 1);
      sm90::fence_proxy_async();
      // this warpgroup's 64 rows of A: rows 64*wgi.. (K-major) or the m
      // block wgi (MN-major), both TILE_BYTES/2 into the tile
      const uint32_t a = ring + s * STAGE + wgi * (TILE_BYTES / 2);
      const uint32_t b = ring + s * STAGE + PARTS * TILE_BYTES;
      const int keep = kt % PROMOTE != 0;  // 0: restart the tensor-core sum
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t da = desc<Op::A_MN>(a, ks);
        const uint64_t db = desc<Op::B_MN>(b, ks);
        sm90::wgmma_m64n128k16_bf16<Op::A_MN, Op::B_MN>(acc, da, db,
                                                        ks == 0 ? keep : 1);
        if (PARTS == 2) {
          sm90::wgmma_m64n128k16_bf16<Op::A_MN, Op::B_MN>(
              acc, da, desc<Op::B_MN>(b + TILE_BYTES, ks), 1);
          sm90::wgmma_m64n128k16_bf16<Op::A_MN, Op::B_MN>(
              acc, desc<Op::A_MN>(a + TILE_BYTES, ks), db, 1);
        }
      }
      sm90::wgmma_commit();
      if (kt % PROMOTE == PROMOTE - 1 || kt == nk - 1) {
        // the window's last k-tile: every group done, then promote
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        if (pending >= 0) sm90::mbar_arrive(&empty[pending]);
        sm90::mbar_arrive(&empty[s]);
        pending = -1;
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      } else {
        sm90::wgmma_wait<1>();  // all but this k-tile's group done
        sm90::fence_regs(acc);
        if (pending >= 0) sm90::mbar_arrive(&empty[pending]);
        pending = s;
      }
    }
    op.epilogue(sum, wgi * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2),
                lane & 3);
  }
}

// launch gemm<Op> on a grid (the shared-memory attribute set first)
template <class Op>
cudaError_t launch(const typename Op::Args& p, dim3 grid, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<Op>();
  cudaError_t e = cudaFuncSetAttribute(
      gemm<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  gemm<Op><<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace
