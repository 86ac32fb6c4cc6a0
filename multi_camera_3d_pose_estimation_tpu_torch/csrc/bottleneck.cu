// One folded HRNet stage-1 Bottleneck on Hopper (sm_90a), bf16 in and out.
//
// Replaces ops/pallas/bottleneck.py::fused_bottleneck_block (one block per
// call) and, launched four times, ::fused_stage1_chain (block 0 with the 1x1
// downsample, then three identity blocks) of the JAX package.
//
// Per output pixel, with BatchNorm folded into W/b on the host
// (ops/bottleneck.py::fold_bottleneck_params):
//   y1  = bf16(relu(x @ W1 + b1))                   1x1 reduce, cin -> 64
//   y2  = bf16(relu(im2col3x3(y1) @ W2 + b2))       3x3 SAME, K = 9*64 = 576
//   identity block: out = bf16(relu((y2 @ W3 + b3) + x))
//   block 0:        out = bf16(relu([y2 | x] @ [W3 | Wd] + (b3 + bd)))
// Block 0's expand and downsample are one product over K = 64 + cin in one
// f32 accumulator (y2's K first), with the two biases added once in f32;
// bottleneck_block_plain sums in the same order.  bf16 operands, f32
// accumulation and the Pallas kernel's bf16 cast points otherwise.  SAME
// padding zero-pads y1 (not x).
//
// Bound at the headline (512 crops of 64x48): an identity block moves 1.61
// GB (x read once, out written once: 0.48 ms at 3.35 TB/s) for 0.22 TFLOP
// (0.22 ms at 989 TFLOP/s), so it is bound by bytes; the four launches of
// the chain move about 5.8 GB (1.74 ms), a single fused launch would move
// 1.0 GB and be bound by its 0.89 TFLOP (0.90 ms).  chip_smoke.py computes
// these bounds from the run's shapes.
//
// Design.  A tile is 64 consecutive pixels of one image (image-local flat
// index, so any H and W); the wgmma M of every product.  A persistent grid
// (one CTA per SM) gives each CTA one run of consecutive tiles, which may
// cross images.  Three warps' worth of roles:
// - Warpgroup 0 (the consumer) runs, per tile u of image b: y1 for the
//   units the 3x3 will need next (L = (W + 64) / 64 units ahead), the 3x3,
//   the expand and the epilogue.  y1 lives in a ring of 2L + 1 units of 64
//   pixels in shared memory, so a y1 row is computed once per image and
//   the halo is recomputed only for the L units before a run's first tile.
// - Warp 4, one thread: TMA loads of x units (64 pixels x cin, 3-D maps
//   over (channel, pixel, image), so a unit is clipped at the image's end)
//   into a ring of NX slots with full/empty mbarriers, running ahead.
// - Warp 5, one thread: W1, W3 (and Wd) 64x64 chunks streamed from L2
//   through a ring of NW 8 KB slots, in the order the consumer takes them.
// W2 (9 taps x 64 x 64 = 72 KB) stays resident.  Every operand tile is
// 64 rows of 128 bytes (64 bf16) with the 128-byte swizzle.
//   y1:  wgmma m64n64k16, A = the x unit (shared-memory descriptor),
//        B = a streamed W1 chunk; epilogue relu(acc + b1) -> bf16 into the
//        y1 ring (same swizzle).
//   y2:  9 taps x 4 wgmma m64n64k16 with A from registers: each lane's
//        ldmatrix row address is the shifted pixel's y1 row (or a zero row
//        outside the image), so a tap's shift costs nothing; B = W2's tap.
//        Two fragment buffers: the next tap's ldmatrix runs under this
//        tap's products.
//   y3:  the y2 accumulators become the A fragments of the expand (no
//        shared memory); 4 output chunks of 64 channels, wgmma
//        m64n64k16, B = a streamed W3 chunk; block 0 then adds the x unit
//        (shared-memory A) times the Wd chunks into the same accumulator.
//   out: identity blocks read the residual from the x unit that y1 read and
//        write the output over it in place; block 0 writes a staging tile.
//        TMA stores the tile; an identity x slot returns to the producer
//        once the store has read it (checked at the next tile's start).
// Shared memory decides the ring sizes: the resident W2 (72 KB), NX x-unit
// slots (32 KB each at cin 256: a unit is held from its y1 until its own
// tile's residual, L + 1 units, plus one loading ahead), the y1 ring (24 KB
// at W <= 63) and NW weight slots.  At cin 256, W 48 that is 72 + 96 + 24
// + 32 KB; keeping W1 and W3 resident too (64 KB more) would leave no x
// slot to load ahead, so they are streamed (64 KB of L2 reads per tile).
// The launcher sizes NX and NW for the shape and refuses what does not fit.
//
// Products go one weight chunk (or one tap) per wgmma group: the previous
// group runs while the next is issued, and a chunk's slot goes back to the
// producer as soon as its group is done (wait_group 1).  One instance per
// (x chunks, downsample): <1..4, true> and <4, false>.  -Xptxas -v: 188
// registers for <4, false>, 192 for <1, true>, 212-225 for the others; a
// 32-byte stack frame and no spills.
//
// Measured on an H100 (PERF.md §6): about 1.27 ms an identity block and
// 1.20 ms block 0 at the headline, 2.6 and 4.0 times their byte bounds.
// Without any product the kernel still takes 0.78 ms: it waits on its
// loads (one x unit ahead at cin 256), not on the tensor cores.  Issuing a
// phase's products back to back, more accumulators, two consumer
// warpgroups and replicated weights (against L2 hot spots) were measured
// and were no faster; a deeper x ring needs shared memory this layout does
// not have.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MID = 64;                // Bottleneck width of HRNet stage 1
constexpr int TM = 64;                 // pixels per tile: the wgmma M
constexpr int CHUNK = TM * 64 * 2;     // one 64-row x 64-bf16 operand tile, 8 KB
constexpr int NCONS = 128;             // the consumer warpgroup
constexpr int NTHREADS = NCONS + 64;   // + the x producer warp + the weight producer warp
constexpr int COUT = 256, NC = 4;      // HRNet stage 1's width: four 64-channel output chunks
constexpr int MAX_X = 5, MAX_W = 8;    // ring slots at most
constexpr int MAX_L = 3;               // units of y1 lookahead at most (W <= 191)
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block can have
constexpr int MAX_DEVICES = 64;        // devices whose SM count and attribute are cached

struct Params {
  const float* b1;
  const float* b2;
  const float* b3;
  const float* bd;
  int B, H, W;
  int TPI, L, NX, NW, NY;  // tiles per image, y1 lookahead, ring slots
};

__host__ __device__ inline size_t smem_bytes(int CK, int has_down, int NX, int NW, int NY) {
  return 1024 + static_cast<size_t>(CHUNK) * (9 + NX * CK + (has_down ? NC : 0) + NY + NW) +
         128 + sizeof(float) * (2 * MID + COUT) + 8 * (2 * MAX_X + 2 * MAX_W + 1);
}

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

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
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

// Byte offset of bf16 pair (row r, 16-byte chunk j, word t) in a swizzled tile.
__device__ __forceinline__ int sw_off(int r, int j, int t) {
  return r * 128 + ((j ^ (r & 7)) << 4) + t * 4;
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
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MC3D_ACC32                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) += A (64 x 16) * B (64 x 16)^T, both from shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : MC3D_ACC32
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, this warpgroup's registers) * B (64 x 16)^T.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : MC3D_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return make_float2(__low2float(v), __high2float(v));
}

// The y1 units computed at the step of tile t (unit u of its image):
// [k0, k1).  A run's first tile and an image's first tile start the ring
// (the halo units before u included); later tiles add the unit L ahead.
__device__ __forceinline__ void y1_range(long long t, long long t_begin, int TPI, int L,
                                         int& k0, int& k1) {
  const int u = static_cast<int>(t % TPI);
  k0 = (t == t_begin || u == 0) ? max(0, u - L) : u + L;
  k1 = min(u + L + 1, TPI);
}

// CK: 64-channel chunks of x; DOWN: block 0 (the downsample) or an
// identity block (CK = 4: cin = cout).
template <int CK, bool DOWN>
__global__ void __launch_bounds__(NTHREADS, 1)
    bottleneck_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_out,
                      const __grid_constant__ CUtensorMap map_w1,
                      const __grid_constant__ CUtensorMap map_w2,
                      const __grid_constant__ CUtensorMap map_w3,
                      const __grid_constant__ CUtensorMap map_wd, Params p) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzled tiles need 1024-byte alignment of their shared addresses.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int NX = p.NX, NW = p.NW, NY = p.NY, TPI = p.TPI, L = p.L;
  const int H = p.H, W = p.W, HW = p.H * p.W;
  constexpr int xbytes = CK * CHUNK;
  uint8_t* sW2 = smem;                                 // 9 taps, resident
  uint8_t* sX = sW2 + 9 * CHUNK;                       // NX x units of CK chunks
  uint8_t* sOut = sX + NX * xbytes;                    // block 0: NC output chunks
  uint8_t* sY1 = sOut + (DOWN ? NC * CHUNK : 0);   // NY y1 units
  uint8_t* sW = sY1 + NY * CHUNK;                      // NW streamed weight chunks
  uint8_t* sZero = sW + NW * CHUNK;                    // one zero row: y1 outside the image
  float* sB1 = reinterpret_cast<float*>(sZero + 128);
  float* sB2 = sB1 + MID;
  float* sB3 = sB2 + MID;  // b3 (+ bd in block 0)
  uint64_t* full_x = reinterpret_cast<uint64_t*>(sB3 + COUT);
  uint64_t* empty_x = full_x + MAX_X;
  uint64_t* full_w = empty_x + MAX_X;
  uint64_t* empty_w = full_w + MAX_W;
  uint64_t* w2_full = empty_w + MAX_W;

  const int tid = threadIdx.x;
  for (int i = tid; i < MID; i += NTHREADS) {
    sB1[i] = p.b1[i];
    sB2[i] = p.b2[i];
  }
  for (int i = tid; i < COUT; i += NTHREADS) sB3[i] = DOWN ? p.b3[i] + p.bd[i] : p.b3[i];
  if (tid < 32) reinterpret_cast<uint32_t*>(sZero)[tid] = 0u;
  if (tid == 0) {
    for (int s = 0; s < NX; ++s) {
      mbar_init(&full_x[s], 1);
      mbar_init(&empty_x[s], 1);  // consumer thread 0 releases, after a consumer barrier
    }
    for (int s = 0; s < NW; ++s) {
      mbar_init(&full_w[s], 1);
      mbar_init(&empty_w[s], 4);  // one arrival per consumer warp
    }
    mbar_init(w2_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long T = static_cast<long long>(p.B) * TPI;
  const long long t_begin = T * blockIdx.x / gridDim.x;
  const long long t_end = T * (blockIdx.x + 1) / gridDim.x;

  if (tid >= NCONS) {
    if (tid == NCONS) {  // ---- x producer (and W2, once)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      mbar_expect_tx(w2_full, 9 * CHUNK);
      for (int tap = 0; tap < 9; ++tap) tma_load_2d(sW2 + tap * CHUNK, &map_w2, w2_full, tap * 64, 0);
      int s = 0;
      uint32_t ph = 0;
      for (long long t = t_begin; t < t_end; ++t) {
        const int b = static_cast<int>(t / TPI);
        int k0, k1;
        y1_range(t, t_begin, TPI, L, k0, k1);
        for (int k = k0; k < k1; ++k) {
          mbar_wait(&empty_x[s], ph ^ 1);
          mbar_expect_tx(&full_x[s], xbytes);
          for (int c = 0; c < CK; ++c)
            tma_load_3d(sX + s * xbytes + c * CHUNK, &map_x, &full_x[s], c * 64, k * TM, b);
          if (++s == NX) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    } else if (tid == NCONS + 32) {  // ---- weight producer: the consumer's order
      int s = 0;
      uint32_t ph = 0;
      auto push = [&](const CUtensorMap* map, int c0, int c1) {
        mbar_wait(&empty_w[s], ph ^ 1);
        mbar_expect_tx(&full_w[s], CHUNK);
        tma_load_2d(sW + s * CHUNK, map, &full_w[s], c0, c1);
        if (++s == NW) {
          s = 0;
          ph ^= 1;
        }
      };
      for (long long t = t_begin; t < t_end; ++t) {
        int k0, k1;
        y1_range(t, t_begin, TPI, L, k0, k1);
        for (int k = k0; k < k1; ++k)
          for (int c = 0; c < CK; ++c) push(&map_w1, c * 64, 0);
        for (int n = 0; n < NC; ++n) {
          push(&map_w3, 0, n * 64);
          if (DOWN)
            for (int c = 0; c < CK; ++c) push(&map_wd, c * 64, n * 64);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  // This lane's ldmatrix row of the tile and 16-byte half of a k16 step.
  const int lrow = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1), lhi = lane >> 4;
  int xi = 0, wi = 0;     // x units and weight chunks taken so far
  int unit_slot[8];       // x slot of each unit still held, by unit & 7
  int pending = -1;       // identity: the x slot whose output store is in flight
  bool w2_ready = false;

  // Take the next streamed weight chunk: its slot, once it has landed.
  auto take_w = [&]() {
    const int ws = wi % NW;
    mbar_wait(&full_w[ws], (wi / NW) & 1);
    ++wi;
    return ws;
  };
  auto give_w = [&](int ws) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_w[ws]);
  };

  for (long long t = t_begin; t < t_end; ++t) {
    const int b = static_cast<int>(t / TPI), u = static_cast<int>(t % TPI);
    if (pending >= 0) {  // the previous tile's store has read its x slot
      if (tid == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(&empty_x[pending]);
      }
      pending = -1;
    }

    // ---- y1 = bf16(relu(x @ W1 + b1)) for the units the 3x3 needs next.
    int k0, k1;
    y1_range(t, t_begin, TPI, L, k0, k1);
    for (int k = k0; k < k1; ++k) {
      const int xs = xi % NX;
      mbar_wait(&full_x[xs], (xi / NX) & 1);
      ++xi;
      unit_slot[k & 7] = xs;
      const uint8_t* xt = sX + xs * xbytes;
      float a1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) a1[i] = 0.f;
      fence_acc(a1);
      int prev = -1;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int ws = take_w();
        wgmma_fence();
        const uint64_t da = sw128_desc(xt + c * CHUNK), db = sw128_desc(sW + ws * CHUNK);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss(a1, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(a1);
        if (prev >= 0) give_w(prev);
        prev = ws;
      }
      wgmma_wait<0>();
      fence_acc(a1);
      give_w(prev);
      uint8_t* ys = sY1 + (k % NY) * CHUNK;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t4;
          *reinterpret_cast<uint32_t*>(ys + sw_off(r, j, t4)) =
              pack2(fmaxf(a1[4 * j + 2 * h] + sB1[col], 0.f),
                    fmaxf(a1[4 * j + 2 * h + 1] + sB1[col + 1], 0.f));
        }
      }
      const long long unit = static_cast<long long>(b) * TPI + k;
      if (unit < t_begin || unit >= t_end) {  // a halo unit: x is not needed again
        named_bar_sync(1, NCONS);
        if (tid == 0) mbar_arrive(&empty_x[xs]);
      }
    }
    named_bar_sync(1, NCONS);  // every warp's y1 rows are written
    if (!w2_ready) {
      mbar_wait(w2_full, 0);
      w2_ready = true;
    }

    // ---- y2 = bf16(relu(im2col3x3(y1) @ W2 + b2)): 9 taps, A from registers.
    const int q = u * TM + lrow;
    const int qy = q / W, qx = q - qy * W;
    float a2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a2[i] = 0.f;
    fence_acc(a2);
    uint32_t fr[2][16];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int yy = qy + tap / 3 - 1, xx = qx + tap % 3 - 1;
      uint32_t base = smem_u32(sZero);
      int sw = 0;
      if (q < HW && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const int pp = yy * W + xx, row = pp & (TM - 1);
        base = smem_u32(sY1 + ((pp / TM) % NY) * CHUNK + row * 128);
        sw = row & 7;
      }
      uint32_t* f = fr[tap & 1];
#pragma unroll
      for (int s = 0; s < 4; ++s) ldsm_x4(f + 4 * s, base + (((2 * s + lhi) ^ sw) << 4));
      wgmma_fence();
      const uint64_t db = sw128_desc(sW2 + tap * CHUNK);
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_rs(a2, f + 4 * s, db + 2 * s);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(a2);
    }
    wgmma_wait<0>();
    fence_acc(a2);
    // The accumulator layout is the A fragment layout: k16 step s takes
    // columns 16 s .. 16 s + 15, i.e. accumulator groups j = 2 s, 2 s + 1.
    uint32_t y2f[16];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * s + e, col = 8 * j + 2 * t4;
        const float c0 = sB2[col], c1 = sB2[col + 1];
        y2f[4 * s + 2 * e] = pack2(fmaxf(a2[4 * j] + c0, 0.f), fmaxf(a2[4 * j + 1] + c1, 0.f));
        y2f[4 * s + 2 * e + 1] =
            pack2(fmaxf(a2[4 * j + 2] + c0, 0.f), fmaxf(a2[4 * j + 3] + c1, 0.f));
      }
    }

    // ---- y3: y2 @ W3 (+ x @ Wd in block 0), 64 output channels per chunk.
    uint8_t* xt = sX + unit_slot[u & 7] * xbytes;
    float acc[NC][32];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
      fence_acc(acc[n]);
    }
    int prev = -1;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      {
        int ws = take_w();
        wgmma_fence();
        uint64_t db = sw128_desc(sW + ws * CHUNK);
#pragma unroll
        for (int s = 0; s < 4; ++s) wgmma_rs(acc[n], y2f + 4 * s, db + 2 * s);
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc[n]);
        if (prev >= 0) give_w(prev);
        prev = ws;
        if (DOWN) {
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            ws = take_w();
            wgmma_fence();
            const uint64_t da = sw128_desc(xt + c * CHUNK);
            db = sw128_desc(sW + ws * CHUNK);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc[n], da + 2 * kk, db + 2 * kk);
            wgmma_commit();
            wgmma_wait<1>();
            fence_acc(acc[n]);
            give_w(prev);
            prev = ws;
          }
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NC; ++n) fence_acc(acc[n]);
    give_w(prev);

    // ---- Epilogue: identity blocks over the x unit in place, block 0 into
    // the staging tile once the previous tile's store has read it.
    uint8_t* ot = DOWN ? sOut : xt;
    if (DOWN) {
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_bar_sync(1, NCONS);
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + g + 8 * h;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * n + 8 * j + 2 * t4;
            uint32_t* at = reinterpret_cast<uint32_t*>(ot + n * CHUNK + sw_off(r, j, t4));
            const float2 bias = *reinterpret_cast<const float2*>(sB3 + col);
            float v0 = acc[n][4 * j + 2 * h] + bias.x;
            float v1 = acc[n][4 * j + 2 * h + 1] + bias.y;
            if (!DOWN) {
              const float2 res = unpack2(*at);
              v0 += res.x;
              v1 += res.y;
            }
            *at = pack2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          }
        }
      }
    }
    // The tile is written through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_bar_sync(1, NCONS);
    if (tid == 0) {
      for (int n = 0; n < NC; ++n) tma_store_3d(&map_out, ot + n * CHUNK, 64 * n, u * TM, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (DOWN) mbar_arrive(&empty_x[unit_slot[u & 7]]);  // its products are done
    }
    if (!DOWN) pending = unit_slot[u & 7];
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// The map of a row-major bf16 tensor of `rank` dims (innermost first) in
// boxes of 64 x 64 (x 1): one 128-byte swizzle row per box row, zero-filled
// beyond the tensor.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims) {
  cuuint64_t strides[2];
  strides[0] = dims[0] * 2;
  if (rank == 3) strides[1] = strides[0] * dims[1];
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                       CUtensorMap, Params);

// The instance for (cin chunks, downsample): identity blocks take cin = 256.
Kernel kernel_for(int CK, int has_down) {
  if (!has_down) return CK == NC ? bottleneck_kernel<NC, false> : nullptr;
  switch (CK) {
    case 1: return bottleneck_kernel<1, true>;
    case 2: return bottleneck_kernel<2, true>;
    case 3: return bottleneck_kernel<3, true>;
    case 4: return bottleneck_kernel<4, true>;
    default: return nullptr;
  }
}

}  // namespace

// Launch one folded Bottleneck on `stream`.  x (B, H, W, cin) and
// out (B, H, W, 256) are contiguous NHWC bf16; w1t (64, cin), w2t
// (64, 9*64) with column (3*kh + kw)*64 + c, w3t (256, 64), wdt (256, cin)
// bf16, biases f32; wdt and bd null for an identity block (cin == 256).
// The wrapper (ops/bottleneck.py) has checked cin % 16 == 0, cin <= 256,
// cout == 256, W <= 191, types, contiguity and 16-byte alignment.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for a shape the kernel does not take or whose rings do not fit).
extern "C" int mc3d_bottleneck_block(const void* x, void* out, const void* w1t,
                                     const void* b1, const void* w2t,
                                     const void* b2, const void* w3t,
                                     const void* b3, const void* wdt,
                                     const void* bd, int B, int H, int W,
                                     int cin, int cout, int has_down,
                                     void* stream) {
  const int CK = (cin + 63) / 64, L = (W + 64) / 64, NY = 2 * L + 1;
  const Kernel kernel = cin > 0 ? kernel_for(CK, has_down) : nullptr;
  if (B <= 0 || H <= 0 || W <= 0 || cin % 16 || cout != COUT || L > MAX_L || !kernel ||
      (!has_down && cin != COUT) || (has_down && (!wdt || !bd)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The most x slots (up to L + 2: one loading ahead), then the most weight slots.
  int NX = 0, NW = 0;
  for (int nx = L + 2; nx >= L + 1 && NX == 0; --nx)
    for (int nw = MAX_W; nw >= 2; --nw)
      if (nx <= MAX_X && smem_bytes(CK, has_down, nx, nw, NY) <= SMEM_LIMIT) {
        NX = nx;
        NW = nw;
        break;
      }
  if (NX == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(CK, has_down, NX, NW, NY);

  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t HW = static_cast<cuuint64_t>(H) * W;
  const cuuint64_t dx[3] = {static_cast<cuuint64_t>(cin), HW, static_cast<cuuint64_t>(B)};
  const cuuint64_t dout[3] = {COUT, HW, static_cast<cuuint64_t>(B)};
  const cuuint64_t dw1[2] = {static_cast<cuuint64_t>(cin), MID};
  const cuuint64_t dw2[2] = {9 * MID, MID};
  const cuuint64_t dw3[2] = {MID, COUT};
  const cuuint64_t dwd[2] = {static_cast<cuuint64_t>(cin), COUT};
  CUtensorMap maps[6];  // x, out, W1, W2, W3, Wd (W3 again for an identity block)
  if (!encode(fn, &maps[0], x, 3, dx) || !encode(fn, &maps[1], out, 3, dout) ||
      !encode(fn, &maps[2], w1t, 2, dw1) || !encode(fn, &maps[3], w2t, 2, dw2) ||
      !encode(fn, &maps[4], w3t, 2, dw3) ||
      !encode(fn, &maps[5], has_down ? wdt : w3t, 2, has_down ? dwd : dw3))
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
  // The shared-memory attribute of every instance, set once per device.
  static bool sized[MAX_DEVICES] = {};
  if (dev >= MAX_DEVICES || !sized[dev]) {
    for (int ck = 1; ck <= NC; ++ck)
      for (int down = 0; down < 2; ++down)
        if (Kernel k = kernel_for(ck, down)) {
          e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
          if (e != cudaSuccess) return static_cast<int>(e);
        }
    if (dev < MAX_DEVICES) sized[dev] = true;
  }
  Params p;
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.bd = static_cast<const float*>(bd);
  p.B = B;
  p.H = H;
  p.W = W;
  p.TPI = static_cast<int>((HW + TM - 1) / TM);
  p.L = L;
  p.NX = NX;
  p.NW = NW;
  p.NY = NY;
  const long long tiles = static_cast<long long>(B) * p.TPI;
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return static_cast<int>(cudaGetLastError());
}
