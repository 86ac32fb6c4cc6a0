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
//   out = bf16(relu((y2 @ W3 + b3) + res))          1x1 expand, 64 -> cout
//   res = x @ Wd + bd (block 0) or x (identity blocks)
// bf16 operands, f32 accumulation, and exactly the Pallas kernel's bf16 cast
// points.  SAME padding zero-pads y1 (not x): halo rows outside the image
// and the left/right padding columns hold y1 = 0.
//
// Bound at the headline (512 crops of 64x48, cin 64 -> 256 then 256 -> 256):
// about 1.74 GFLOP per image, 0.89 TFLOP per block of 512 crops for the four
// launches, 0.9 ms at the card's 989 TFLOP/s bf16 peak; the four launches
// move about 5.8 GB (1.7 ms at 3.35 TB/s), so the chain as four launches is
// bound by bytes, and a fused chain (1.0 GB) would be bound by operations.
//
// Design (simple first, not yet fast):
// - A persistent grid, one CTA of 8 warps per SM, loads all folded weights
//   into shared memory once (W2 as (64, 576) bf16 is 72 KB; W1, W3, Wd up
//   to 32 KB each) and then walks tiles of (image, R output rows).
// - Phase A computes y1 for the R rows plus a one-row halo above and below
//   into shared memory (the halo rows are recomputed by the neighbouring
//   tile, 1.5x the reduce work at R = 4).  Phase B runs the 3x3 as an
//   im2col product read straight from that tile with shifted addresses.
//   Phase C runs the expand, the residual and the store.
// - Products are warp-level mma.sync m16n8k16 (bf16 -> f32).  x is read
//   from global memory (L2) as A fragments; shared rows are padded by
//   8 bf16 so fragment loads are free of bank conflicts.
// - wgmma/TMA and fusing the whole chain in one launch are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MID = 64;        // Bottleneck width of HRNet stage 1
constexpr int K2 = 9 * MID;    // im2col depth of the 3x3
constexpr int PAD = 8;         // bf16 padding per shared row (bank spread)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

struct Params {
  const bf16* x;
  bf16* out;
  const bf16* w1t;  // (MID, cin)   [n][k]
  const float* b1;
  const bf16* w2t;  // (MID, 9*MID) [n][(3*kh + kw)*MID + c]
  const float* b2;
  const bf16* w3t;  // (cout, MID)
  const float* b3;
  const bf16* wdt;  // (cout, cin) or null
  const float* bd;
  int B, H, W, cin, cout, R, has_down;
};

struct Layout {
  size_t w1, w2, w3, wd, y1, y2, b1, b2, b3, bd, total;
};

__host__ __device__ inline int m_tiles(int rows) { return (rows + 15) / 16; }

__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  size_t at = off;
  off += (bytes + 15) & ~static_cast<size_t>(15);
  return at;
}

// Byte offsets of every shared-memory region; the host sizes the launch
// with the same function the kernel carves with.
__host__ __device__ inline Layout layout(int cin, int cout, int W, int R,
                                         int has_down) {
  Layout L;
  size_t off = 0;
  L.w1 = take(off, sizeof(bf16) * MID * (cin + PAD));
  L.w2 = take(off, sizeof(bf16) * MID * (K2 + PAD));
  L.w3 = take(off, sizeof(bf16) * cout * (MID + PAD));
  L.wd = take(off, has_down ? sizeof(bf16) * cout * (cin + PAD) : 0);
  L.y1 = take(off, sizeof(bf16) * (R + 2) * (W + 2) * (MID + PAD));
  L.y2 = take(off, sizeof(bf16) * m_tiles(R * W) * 16 * (MID + PAD));
  L.b1 = take(off, sizeof(float) * MID);
  L.b2 = take(off, sizeof(float) * MID);
  L.b3 = take(off, sizeof(float) * cout);
  L.bd = take(off, sizeof(float) * cout);
  L.total = off;
  return L;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Two floats -> packed bf16x2, the lower column in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return make_float2(__low2float(v), __high2float(v));
}

// rows x cols bf16 (cols % 8 == 0, 16-byte aligned) from global into a
// shared array with row stride ld.
__device__ void copy_rows(bf16* dst, int ld, const bf16* src, int rows,
                          int cols) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * cols + c);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) bottleneck_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cin = p.cin, cout = p.cout, H = p.H, W = p.W, R = p.R;
  const Layout L = layout(cin, cout, W, R, p.has_down);
  bf16* sW1 = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* sW2 = reinterpret_cast<bf16*>(smem + L.w2);
  bf16* sW3 = reinterpret_cast<bf16*>(smem + L.w3);
  bf16* sWd = reinterpret_cast<bf16*>(smem + L.wd);
  bf16* sY1 = reinterpret_cast<bf16*>(smem + L.y1);
  bf16* sY2 = reinterpret_cast<bf16*>(smem + L.y2);
  float* sB1 = reinterpret_cast<float*>(smem + L.b1);
  float* sB2 = reinterpret_cast<float*>(smem + L.b2);
  float* sB3 = reinterpret_cast<float*>(smem + L.b3);
  float* sBd = reinterpret_cast<float*>(smem + L.bd);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int ldw1 = cin + PAD, ldw2 = K2 + PAD, ldw3 = MID + PAD;
  const int ldwd = cin + PAD, ldy = MID + PAD;

  copy_rows(sW1, ldw1, p.w1t, MID, cin);
  copy_rows(sW2, ldw2, p.w2t, MID, K2);
  copy_rows(sW3, ldw3, p.w3t, cout, MID);
  if (p.has_down) copy_rows(sWd, ldwd, p.wdt, cout, cin);
  for (int i = tid; i < MID; i += NTHREADS) {
    sB1[i] = p.b1[i];
    sB2[i] = p.b2[i];
  }
  for (int i = tid; i < cout; i += NTHREADS) {
    sB3[i] = p.b3[i];
    if (p.has_down) sBd[i] = p.bd[i];
  }
  // Zero the y1 tile once: its padding columns are never written again.
  {
    uint32_t* z = reinterpret_cast<uint32_t*>(sY1);
    const int words = (R + 2) * (W + 2) * ldy / 2;
    for (int i = tid; i < words; i += NTHREADS) z[i] = 0u;
  }
  __syncthreads();

  const int tiles_per_img = (H + R - 1) / R;
  const int ntiles = p.B * tiles_per_img;
  const int P = (R + 2) * W;  // y1 pixels of a tile, halo rows included
  const int Q = R * W;        // output pixels of a tile
  const int MA = m_tiles(P), MB = m_tiles(Q);
  const int NG = cout / 64;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tiles_per_img;
    const int y0 = (tile - b * tiles_per_img) * R;
    const bf16* xb = p.x + static_cast<size_t>(b) * H * W * cin;
    bf16* ob = p.out + static_cast<size_t>(b) * H * W * cout;

    // ---- Phase A: y1 for image rows y0-1 .. y0+R, zero outside the image.
    for (int u = warp; u < MA * 2; u += NWARPS) {
      const int mt = u >> 1, nb = (u & 1) * 32;
      const int pa = mt * 16 + g, pb = pa + 8;
      const bf16* ra = nullptr;
      const bf16* rb = nullptr;
      if (pa < P) {
        const int yy = y0 - 1 + pa / W;
        if (yy >= 0 && yy < H)
          ra = xb + (static_cast<size_t>(yy) * W + pa % W) * cin;
      }
      if (pb < P) {
        const int yy = y0 - 1 + pb / W;
        if (yy >= 0 && yy < H)
          rb = xb + (static_cast<size_t>(yy) * W + pb % W) * cin;
      }
      float acc[4][4] = {};
#pragma unroll 4
      for (int k0 = 0; k0 < cin; k0 += 16) {
        uint32_t a[4];
        a[0] = ra ? ldg32(ra + k0 + 2 * t) : 0u;
        a[1] = rb ? ldg32(rb + k0 + 2 * t) : 0u;
        a[2] = ra ? ldg32(ra + k0 + 2 * t + 8) : 0u;
        a[3] = rb ? ldg32(rb + k0 + 2 * t + 8) : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bf16* wr = sW1 + (nb + j * 8 + g) * ldw1 + k0 + 2 * t;
          mma_bf16(acc[j], a, lds32(wr), lds32(wr + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nb + j * 8 + 2 * t;
        const float c0 = sB1[col], c1 = sB1[col + 1];
        if (pa < P) {
          bf16* d = sY1 + ((pa / W) * (W + 2) + pa % W + 1) * ldy + col;
          *reinterpret_cast<uint32_t*>(d) =
              ra ? pack2(fmaxf(acc[j][0] + c0, 0.f), fmaxf(acc[j][1] + c1, 0.f))
                 : 0u;
        }
        if (pb < P) {
          bf16* d = sY1 + ((pb / W) * (W + 2) + pb % W + 1) * ldy + col;
          *reinterpret_cast<uint32_t*>(d) =
              rb ? pack2(fmaxf(acc[j][2] + c0, 0.f), fmaxf(acc[j][3] + c1, 0.f))
                 : 0u;
        }
      }
    }
    __syncthreads();

    // ---- Phase B: y2 = 3x3 SAME over the y1 tile, as a K = 576 product.
    for (int u = warp; u < MB * 2; u += NWARPS) {
      const int mt = u >> 1, nb = (u & 1) * 32;
      const int qa = min(mt * 16 + g, Q - 1), qb = min(mt * 16 + g + 8, Q - 1);
      // Top-left tap of output pixel (r, c) sits at y1 tile (r, c).
      const bf16* ya = sY1 + ((qa / W) * (W + 2) + qa % W) * ldy + 2 * t;
      const bf16* yb = sY1 + ((qb / W) * (W + 2) + qb % W) * ldy + 2 * t;
      float acc[4][4] = {};
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = ((tap / 3) * (W + 2) + tap % 3) * ldy;
#pragma unroll
        for (int c0 = 0; c0 < MID; c0 += 16) {
          uint32_t a[4];
          a[0] = lds32(ya + toff + c0);
          a[1] = lds32(yb + toff + c0);
          a[2] = lds32(ya + toff + c0 + 8);
          a[3] = lds32(yb + toff + c0 + 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bf16* wr =
                sW2 + (nb + j * 8 + g) * ldw2 + tap * MID + c0 + 2 * t;
            mma_bf16(acc[j], a, lds32(wr), lds32(wr + 8));
          }
        }
      }
      const int q0 = mt * 16 + g, q1 = q0 + 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nb + j * 8 + 2 * t;
        const float c0 = sB2[col], c1 = sB2[col + 1];
        if (q0 < Q)
          *reinterpret_cast<uint32_t*>(sY2 + q0 * ldy + col) =
              pack2(fmaxf(acc[j][0] + c0, 0.f), fmaxf(acc[j][1] + c1, 0.f));
        if (q1 < Q)
          *reinterpret_cast<uint32_t*>(sY2 + q1 * ldy + col) =
              pack2(fmaxf(acc[j][2] + c0, 0.f), fmaxf(acc[j][3] + c1, 0.f));
      }
    }
    __syncthreads();

    // ---- Phase C: out = relu((y2 @ W3 + b3) + res), 64 columns per unit.
    // The next tile's phase A writes only y1, and its phase B (which
    // rewrites y2) waits at the barrier above for every warp to leave C.
    for (int u = warp; u < MB * NG; u += NWARPS) {
      const int mt = u / NG, nb = (u - mt * NG) * 64;
      const int qa = mt * 16 + g, qb = qa + 8;
      const bool va = qa < Q && y0 + qa / W < H;
      const bool vb = qb < Q && y0 + qb / W < H;
      const size_t pixa = static_cast<size_t>(y0 + qa / W) * W + qa % W;
      const size_t pixb = static_cast<size_t>(y0 + qb / W) * W + qb % W;
      float acc[8][4] = {};
#pragma unroll
      for (int c0 = 0; c0 < MID; c0 += 16) {
        uint32_t a[4];
        a[0] = lds32(sY2 + qa * ldy + c0 + 2 * t);
        a[1] = lds32(sY2 + qb * ldy + c0 + 2 * t);
        a[2] = lds32(sY2 + qa * ldy + c0 + 2 * t + 8);
        a[3] = lds32(sY2 + qb * ldy + c0 + 2 * t + 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bf16* wr = sW3 + (nb + j * 8 + g) * ldw3 + c0 + 2 * t;
          mma_bf16(acc[j], a, lds32(wr), lds32(wr + 8));
        }
      }
      float res[8][4] = {};
      if (p.has_down) {
        const bf16* ra = va ? xb + pixa * cin : nullptr;
        const bf16* rb = vb ? xb + pixb * cin : nullptr;
#pragma unroll 2
        for (int k0 = 0; k0 < cin; k0 += 16) {
          uint32_t a[4];
          a[0] = ra ? ldg32(ra + k0 + 2 * t) : 0u;
          a[1] = rb ? ldg32(rb + k0 + 2 * t) : 0u;
          a[2] = ra ? ldg32(ra + k0 + 2 * t + 8) : 0u;
          a[3] = rb ? ldg32(rb + k0 + 2 * t + 8) : 0u;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const bf16* wr = sWd + (nb + j * 8 + g) * ldwd + k0 + 2 * t;
            mma_bf16(res[j], a, lds32(wr), lds32(wr + 8));
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = nb + j * 8 + 2 * t;
          res[j][0] += sBd[col];
          res[j][1] += sBd[col + 1];
          res[j][2] += sBd[col];
          res[j][3] += sBd[col + 1];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = nb + j * 8 + 2 * t;
          if (va) {
            const float2 r = unpack2(ldg32(xb + pixa * cin + col));
            res[j][0] = r.x;
            res[j][1] = r.y;
          }
          if (vb) {
            const float2 r = unpack2(ldg32(xb + pixb * cin + col));
            res[j][2] = r.x;
            res[j][3] = r.y;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb + j * 8 + 2 * t;
        const float c0 = sB3[col], c1 = sB3[col + 1];
        if (va)
          *reinterpret_cast<uint32_t*>(ob + pixa * cout + col) =
              pack2(fmaxf((acc[j][0] + c0) + res[j][0], 0.f),
                    fmaxf((acc[j][1] + c1) + res[j][1], 0.f));
        if (vb)
          *reinterpret_cast<uint32_t*>(ob + pixb * cout + col) =
              pack2(fmaxf((acc[j][2] + c0) + res[j][2], 0.f),
                    fmaxf((acc[j][3] + c1) + res[j][3], 0.f));
      }
    }
  }
}

}  // namespace

// Launch one folded Bottleneck on `stream`.  x (B, H, W, cin) and
// out (B, H, W, cout) are contiguous NHWC bf16; the weights are laid out as
// in Params.  Returns the CUDA error code of the launch (0 on success).
// The wrapper (ops/bottleneck.py) has checked shapes, types and contiguity.
extern "C" int mc3d_bottleneck_block(const void* x, void* out, const void* w1t,
                                     const void* b1, const void* w2t,
                                     const void* b2, const void* w3t,
                                     const void* b3, const void* wdt,
                                     const void* bd, int B, int H, int W,
                                     int cin, int cout, int has_down,
                                     void* stream) {
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Rows per tile: the tallest of 4..1 whose tile fits in shared memory.
  int R = 4;
  while (R > 1 && layout(cin, cout, W, R, has_down).total >
                      static_cast<size_t>(max_smem))
    --R;
  const size_t smem = layout(cin, cout, W, R, has_down).total;
  if (smem > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(bottleneck_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.w1t = static_cast<const bf16*>(w1t);
  p.b1 = static_cast<const float*>(b1);
  p.w2t = static_cast<const bf16*>(w2t);
  p.b2 = static_cast<const float*>(b2);
  p.w3t = static_cast<const bf16*>(w3t);
  p.b3 = static_cast<const float*>(b3);
  p.wdt = static_cast<const bf16*>(wdt);
  p.bd = static_cast<const float*>(bd);
  p.B = B;
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.cout = cout;
  p.R = R;
  p.has_down = has_down;
  const int ntiles = B * ((H + R - 1) / R);
  const int grid = ntiles < sms ? ntiles : sms;
  bottleneck_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
