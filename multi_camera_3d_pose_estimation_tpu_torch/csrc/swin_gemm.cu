// The four token products of a SwinBlock on Hopper (sm_90a), bf16 in and out.
//
// Replaces, with csrc/window_attention.cu, the JAX package's
// ops/pallas/swin_block.py::fused_swin_block (its _block_body), and the
// same products of fused_swin_block_fixed and fused_swin_stage_fixed.  A
// block is five launches of mc3d_swin_gemm and the attention: three modes
// of this GEMM around the attention kernel.
//   out (M, N) = A (M, K) @ W^T, W (N, K) as torch.nn.Linear keeps it,
// bf16 operands, f32 accumulation, and exactly the Pallas kernel's cast
// points per mode:
//   MODE_LN_QKV  A = bf16(LN1(x) * valid)   out = bf16(bf16(acc) + bf16(b))
//   MODE_RESID   A = x                       out = bf16(res + bf16(bf16(acc) + bf16(b)))
//                                            (* valid when given: pad tokens
//                                            leave as exact zeros)
//   MODE_LN_GELU A = bf16(LN2(x))            out = bf16(gelu_erf(acc + b))
// LN: f32 statistics, var = E[x^2] - E[x]^2, y = (x - mu) * rsqrt(var + eps)
// * gamma + beta.  valid (period floats, 1 or 0) is indexed by row % period:
// the token's place in its crop's window layout.
//
// Bound at the Swin-B shapes, 256 crops: only the map's real tokens need
// products (window padding enters qkv as zeros and leaves zeroed or
// cropped), so the four products of one block are 24 * C^2 flops for each
// of the 786,432 real tokens at stage 0, 196,608 at stage 1, 49,152 at
// stage 2 and 12,288 at stage 3: 0.31 TFLOP at every stage.  With the
// attention's 4 * n * C per real query, all 24 backbone blocks are 7.6
// TFLOP, 7.66 ms at 989 TFLOP/s, against at most 0.40 GB of tokens read and
// written per block (0.12 ms at 3.35 TB/s, stage 0): bound by operations
// (chip_smoke.py computes these bounds from the run's shapes).  Only
// wgmma reaches the tensor cores' rate, so the design is built around it:
//
// - LayerNorm modes first run swin_gemm_ln_kernel (16 or 32 lanes per row,
//   the row read once into registers): the row's statistics once, then
//   bf16(LN(x) * valid) into a scratch operand that the GEMM reads like
//   any A.  Normalising each raw A tile in shared memory on its way to
//   wgmma instead (a statistics kernel, then the tile normalised in place)
//   repeats the work for every N tile of the row (3-24 of them).  Both
//   ways of doing that on this kernel, by three producer warps or by the
//   consumers while the stage before runs its wgmma, measured slower on
//   the card, 2.9x and 1.4x the LN products' time with this pass, which
//   costs 2 bytes written and read per row element (PERF.md §6).
// - The GEMM: a persistent grid (one CTA per SM) walks 128 x 128 output
//   tiles, the N tiles of one M tile on neighbouring CTAs so they share A
//   in L2.  Each tile is computed whole by one warpgroup in one K order:
//   no split-K, so a row's result does not depend on where it sits in M.
// - Warpgroup 2 is the producer: one thread issues TMA loads of 128 x 64 A
//   and W tiles (128-byte swizzle, zero-filled beyond M, N and K) into a
//   ring of 4-5 stages in dynamic shared memory, with a "full" (expect-tx)
//   and an "empty" mbarrier per stage, and runs ahead across tiles.
// - Warpgroups 0 and 1 are the consumers and take the CTA's tiles in turn
//   (ping-pong): per 64-deep stage eight wgmma.m64n128k16, both operands
//   K-major from shared memory, one group in flight.  A warpgroup's
//   products start when the other's are all issued, so one warpgroup's
//   epilogue runs beside the other's products.
// - Epilogue: the residual tile arrives by TMA in the warpgroup's 32 KB
//   buffer while its products run; the accumulators, bias (from shared
//   memory), residual and valid are combined at the cast points above and
//   written back in place, and TMA stores the tile (clipped at M and N).
//   Registers are rebalanced (setmaxnreg) from the producer to the
//   consumers, which hold a 128 x 128 f32 accumulator each.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { MODE_LN_QKV = 0, MODE_RESID = 1, MODE_LN_GELU = 2 };

constexpr int BM = 128, BN = 128, BK = 64;  // BK bf16 = one 128-byte swizzle row
constexpr int NTHREADS = 384;               // warpgroups 0 and 1 consume, 2 produces
constexpr int MAX_STAGES = 5;
constexpr int TILE_A_BYTES = BM * BK * 2, TILE_W_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = TILE_A_BYTES + TILE_W_BYTES;
constexpr int HALF_BYTES = BM * 64 * 2;    // a 128 x 64 half of an output tile
constexpr int EPI_BYTES = 2 * HALF_BYTES;  // a warpgroup's residual/output tile
constexpr int SMEM_LIMIT = 232448;         // dynamic shared memory a block can have
constexpr int LN_THREADS = 256, LN_CHUNKS = 4;  // the LayerNorm kernel's block, registers
constexpr int MAX_DEVICES = 64;                 // devices whose SM count and attribute are cached

struct Params {
  const float* bias;
  const float* valid;
  int M, N, K, period, stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO); the leading offset is unused.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across wgmma sync points.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) * B (128 x 16)^T, both from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return make_float2(__low2float(v), __high2float(v));
}

__device__ __forceinline__ float bf(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

// out = bf16(LN(x) * valid[row % period]) of each row of A (M, K): G lanes
// per row (16 for K <= 128, else 32), each holding up to LN_CHUNKS 16-byte
// chunks of the row in registers, so a row is read once for K <= 32 * G;
// f32 sums of x and x^2 reduced across the G lanes, then normalised.
template <int G>
__global__ void __launch_bounds__(LN_THREADS)
    swin_gemm_ln_kernel(const bf16* __restrict__ A, const float* __restrict__ ln_w,
                        const float* __restrict__ ln_b, const float* __restrict__ valid,
                        bf16* __restrict__ out, int M, int K, int period, float eps) {
  const int row = (blockIdx.x * LN_THREADS + threadIdx.x) / G, sub = threadIdx.x % G;
  const bool live = row < M;  // every lane takes part in the shuffles
  const bf16* a = A + static_cast<size_t>(live ? row : 0) * K;
  uint4 x[LN_CHUNKS];
  float s = 0.f, s2 = 0.f;
  auto add = [&](const uint4& u) {
    const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack2(w4[e]);
      s += f.x + f.y;
      s2 += f.x * f.x + f.y * f.y;
    }
  };
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int k = (sub + G * c) * 8;
    if (live && k < K) {
      x[c] = *reinterpret_cast<const uint4*>(a + k);
      add(x[c]);
    }
  }
  for (int k = (sub + G * LN_CHUNKS) * 8; live && k < K; k += 8 * G)  // rows beyond the registers
    add(*reinterpret_cast<const uint4*>(a + k));
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (!live) return;
  const float mu = s / K, rs = rsqrtf(s2 / K - mu * mu + eps);
  const float v = valid ? valid[row % period] : 1.f;
  bf16* y = out + static_cast<size_t>(row) * K;
  auto norm = [&](const uint4& u, int k) {
    const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
    const float4 g0 = *reinterpret_cast<const float4*>(ln_w + k);
    const float4 g1 = *reinterpret_cast<const float4*>(ln_w + k + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(ln_b + k);
    const float4 b1 = *reinterpret_cast<const float4*>(ln_b + k + 4);
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint32_t y4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack2(w4[e]);
      y4[e] = pack2(((f.x - mu) * rs * g[2 * e] + b[2 * e]) * v,
                    ((f.y - mu) * rs * g[2 * e + 1] + b[2 * e + 1]) * v);
    }
    *reinterpret_cast<uint4*>(y + k) = make_uint4(y4[0], y4[1], y4[2], y4[3]);
  };
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int k = (sub + G * c) * 8;
    if (k < K) norm(x[c], k);
  }
  for (int k = (sub + G * LN_CHUNKS) * 8; k < K; k += 8 * G)
    norm(*reinterpret_cast<const uint4*>(a + k), k);
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 1)
    swin_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_res,
                     const __grid_constant__ CUtensorMap map_out, Params p) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzled tiles need 1024-byte alignment of their shared addresses.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int S = p.stages, M = p.M, N = p.N, K = p.K;
  uint8_t* epi = smem + S * STAGE_BYTES;  // [2][EPI_BYTES]: each consumer's out tile
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * EPI_BYTES);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* turn = empty + MAX_STAGES;  // turn[c]: warpgroup c may start its products
  uint64_t* res_full = turn + 2;        // res_full[c]: warpgroup c's residual tile landed
  const int n_tiles = (N + BN - 1) / BN;
  float* s_bias = reinterpret_cast<float*>(res_full + 2);  // n_tiles * BN, zero-padded

  const int tid = threadIdx.x;
  for (int i = tid; i < n_tiles * BN; i += NTHREADS) s_bias[i] = i < N ? p.bias[i] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(&turn[c], 4);
      mbar_init(&res_full[c], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = (M + BM - 1) / BM * n_tiles, KT = (K + BK - 1) / BK;

  if (tid >= 256) {  // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_w))
                   : "memory");
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          uint8_t* slot = smem + s * STAGE_BYTES;
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(slot, &map_a, &full[s], kt * BK, m0);
          tma_load_2d(slot + TILE_A_BYTES, &map_w, &full[s], kt * BK, n0);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw takes the CTA's tiles 2 q + cw (ping-pong).
  // Their products run in turns, so one warpgroup's epilogue runs beside
  // the other's products, and a warpgroup never waits on a ring stage more
  // than one phase ahead of the producer.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = tid >> 7, tw = tid & 127, warp = tw >> 5, lane = tw & 31;
  uint8_t* ebuf = epi + cw * EPI_BYTES;
  float acc[2][64];  // rows 0-63 and 64-127 of the tile
  uint32_t turn_phase = 0, res_phase = 0;
  for (int seq = cw, t = blockIdx.x + cw * gridDim.x; t < tiles;
       seq += 2, t += 2 * gridDim.x) {
    const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
    const int halves = n0 + 64 < N ? 2 : 1;  // 64-column halves of the tile inside N
    if (MODE == MODE_RESID && tw == 0) {
      // The residual tile, once the previous tile's store has left the buffer.
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_expect_tx(&res_full[cw], halves * HALF_BYTES);
      for (int hf = 0; hf < halves; ++hf)
        tma_load_2d(ebuf + hf * HALF_BYTES, &map_res, &res_full[cw], n0 + 64 * hf, m0);
    }
    const long long g0 = static_cast<long long>(seq) * KT;  // the ring's step count
    int s = static_cast<int>(g0 % S);
    uint32_t phase = static_cast<uint32_t>((g0 / S) & 1);
    if (seq > 0) {  // the previous tile's products have all been issued
      mbar_wait(&turn[cw], turn_phase);
      turn_phase ^= 1;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    fence_acc(acc[0]);
    fence_acc(acc[1]);

    int prev = -1;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[s], phase);
      uint8_t* a_tile = smem + s * STAGE_BYTES;
      wgmma_fence();
      const uint64_t da = sw128_desc(a_tile), db = sw128_desc(a_tile + TILE_A_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // 32 bytes of K per step
        wgmma_m64n128k16(acc[0], da + 2 * kk, db + 2 * kk);
        wgmma_m64n128k16(acc[1], da + ((64 * BK * 2) >> 4) + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products have retired
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&turn[cw ^ 1]);  // the other warpgroup's turn
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // ---- Epilogue, in place in the warpgroup's buffer: two 128 x 64
    // halves with the 128-byte swizzle of the out/res maps.  Fragment of
    // accumulator hh: rows 64 hh + 16 warp + lane / 4 (+ 8), columns
    // 8 j + 2 (lane % 4) (+ 1).  Rows and columns beyond M and N are
    // computed on zeros and clipped by the store.
    if (MODE == MODE_RESID) {
      mbar_wait(&res_full[cw], res_phase);
      res_phase ^= 1;
    } else {
      if (tw == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_bar_sync(1 + cw, 128);  // the previous tile's store has left the buffer
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * hh + 16 * warp + (lane >> 2) + 8 * h;
        float v = 1.f;
        if (MODE == MODE_RESID && p.valid) v = p.valid[(m0 + r) % p.period];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          uint32_t* at = reinterpret_cast<uint32_t*>(
              ebuf + (j >> 3) * HALF_BYTES + r * 128 + (((j & 7) ^ (r & 7)) << 4) +
              (lane & 3) * 4);
          const float c0 = acc[hh][4 * j + 2 * h], c1 = acc[hh][4 * j + 2 * h + 1];
          const float b0 = s_bias[n0 + col], b1 = s_bias[n0 + col + 1];
          uint32_t o;
          if (MODE == MODE_LN_QKV) {
            o = pack2(bf(c0) + bf(b0), bf(c1) + bf(b1));
          } else if (MODE == MODE_RESID) {
            const float2 rr = unpack2(*at);
            o = pack2(bf(rr.x + bf(bf(c0) + bf(b0))) * v, bf(rr.y + bf(bf(c1) + bf(b1))) * v);
          } else {
            const float h0 = c0 + b0, h1 = c1 + b1;
            o = pack2(0.5f * h0 * (1.f + erff(h0 * 0.70710677f)),
                      0.5f * h1 * (1.f + erff(h1 * 0.70710677f)));
          }
          *at = o;
        }
      }
    }
    // The tile is written through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_bar_sync(1 + cw, 128);
    if (tw == 0) {
      for (int hf = 0; hf < halves; ++hf)
        tma_store_2d(&map_out, ebuf + hf * HALF_BYTES, n0 + 64 * hf, m0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tw == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The map of a row-major bf16 (rows, cols) matrix in boxes of 128 rows x 64
// columns (one 128-byte swizzle row each).
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, 128};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE>
int launch(const CUtensorMap* maps, const Params& p, int dev, int grid, int smem,
           cudaStream_t s) {
  static bool sized[MAX_DEVICES] = {};  // the attribute is set per device
  if (dev >= MAX_DEVICES || !sized[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        swin_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) sized[dev] = true;
  }
  swin_gemm_kernel<MODE><<<grid, NTHREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one Swin token product on `stream` (mode: 0 LN->qkv, 1 residual,
// 2 LN->fc1->GELU).  A (M, K), W (N, K), res and out (M, N) bf16; bias (N),
// ln_w/ln_b (K) and valid (period) f32; a_ln (M, K) bf16 scratch for the LN
// modes, which launch swin_gemm_ln_kernel into it first; res, ln_*, valid
// and a_ln may be null where the mode does not read them.  The wrapper
// (ops/swin_block.py) has checked N % 8 == 0, K % 32 == 0, types,
// contiguity and 16-byte alignment.  Returns the CUDA error code of the
// launches.
extern "C" int mc3d_swin_gemm(int mode, const void* A, const void* W, const void* bias,
                              const void* res, const void* ln_w, const void* ln_b,
                              const void* valid, void* a_ln, void* out, int M, int N, int K,
                              int period, float eps, void* stream) {
  const bool ln = mode != MODE_RESID;
  if (mode < 0 || mode > 2 || M <= 0 || N <= 0 || N % 8 || K <= 0 || K % 32 ||
      (valid && period <= 0) || (ln && (!a_ln || !ln_w || !ln_b)) || (!ln && !res))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_pad = (N + BN - 1) / BN * BN;
  const int extras = 1024 + 2 * EPI_BYTES + (2 * MAX_STAGES + 4) * 8 + 4 * n_pad;
  int stages = (SMEM_LIMIT - extras) / STAGE_BYTES;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap maps[4];  // A (or its normalised copy), W, res, out
  if (!encode(fn, &maps[0], ln ? a_ln : A, M, K) || !encode(fn, &maps[1], W, N, K) ||
      !encode(fn, &maps[2], ln ? out : res, M, N) || !encode(fn, &maps[3], out, M, N))
    return static_cast<int>(cudaErrorInvalidValue);

  static int sms_of[MAX_DEVICES] = {};  // SM count per device, read once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = dev < MAX_DEVICES ? sms_of[dev] : 0;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) sms_of[dev] = sms;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ln) {
    const bf16* a = static_cast<const bf16*>(A);
    const float *g = static_cast<const float*>(ln_w), *b = static_cast<const float*>(ln_b),
                *v = static_cast<const float*>(valid);
    bf16* y = static_cast<bf16*>(a_ln);
    if (K <= 128)
      swin_gemm_ln_kernel<16><<<(M + LN_THREADS / 16 - 1) / (LN_THREADS / 16), LN_THREADS, 0, s>>>(
          a, g, b, v, y, M, K, period, eps);
    else
      swin_gemm_ln_kernel<32><<<(M + LN_THREADS / 32 - 1) / (LN_THREADS / 32), LN_THREADS, 0, s>>>(
          a, g, b, v, y, M, K, period, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Params p;
  p.bias = static_cast<const float*>(bias);
  p.valid = static_cast<const float*>(valid);
  p.M = M;
  p.N = N;
  p.K = K;
  p.period = period;
  p.stages = stages;
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * (n_pad / BN);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  const int smem = stages * STAGE_BYTES + extras;
  switch (mode) {
    case MODE_LN_QKV:
      return launch<MODE_LN_QKV>(maps, p, dev, grid, smem, s);
    case MODE_RESID:
      return launch<MODE_RESID>(maps, p, dev, grid, smem, s);
    default:
      return launch<MODE_LN_GELU>(maps, p, dev, grid, smem, s);
  }
}
