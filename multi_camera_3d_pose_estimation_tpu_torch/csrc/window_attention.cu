// Swin window attention core on Hopper (sm_90a), bf16 in and out.
//
// Replaces, in the JAX package, ops/pallas/window_attention.py::
// fused_window_attention (one window per grid step) and ::
// packed_window_attention (several windows per matrix-unit pass), and the attention
// step of ops/pallas/swin_block.py::fused_swin_block.  For window w and head h
// of qkv (Bw, n, 3C) (q | k | v, C = heads * 32):
//   s   = f32(q_h k_h^T) * 32^-1/2 + bias[h] + mask[w mod nW]
//   p   = bf16(softmax_f32(s))            (row-wise)
//   ctx = bf16(f32(p v_h))                -> out[w, :, h*32 : h*32+32]
// exactly the Pallas kernels' cast points.  The TPU kernels' packing of WB
// windows into one block-diagonal product (-1e5 off the diagonal) works
// around the TPU matrix unit's per-pass latency; here each window is its own.
//
// Bound at the Swin-B stage-0 shapes (256 crops: 17,920 windows of n = 49,
// C = 128, 4 heads; 786,432 of the 878,080 window tokens are real, the rest
// window padding): it must read the real tokens' q (201 MB) and every
// token's k and v (450 MB) and write the real tokens' ctx (201 MB), 0.25 ms
// at 3.35 TB/s, while the products of n keys for each real query are
// 20 GFLOP (0.02 ms at 989 TFLOP/s): bound by bytes at every stage (0.25,
// 0.14, 0.08, 0.05 ms per launch, 2.24 ms for the 24 blocks; chip_smoke.py
// computes them).  So the design reads each qkv row once and
// keeps the scores and probabilities in registers; nothing but ctx is
// written.
//
// Design (simple first, not yet fast):
// - One CTA of 4 warps per window, looping over heads.  The window's n <= 64
//   tokens are padded to 64 rows; warp i owns query rows 16i .. 16i+15.
// - Per head, q, k and v^T (64 x 32 each, bf16, zero in the padding rows)
//   and bias[h] are staged in shared memory; the window's mask row is staged
//   once.  Shared rows are padded by 8 bf16 so fragment loads are free of
//   bank conflicts.
// - S = Q K^T is 2 k-steps x 8 n-tiles of mma.sync m16n8k16 (bf16 -> f32)
//   per warp; columns >= n get -inf.  The row softmax runs in f32 on the
//   accumulator registers: the four lanes that share a row reduce max and sum
//   with two shuffles.  The normalized probabilities are rounded to bf16 and
//   re-packed in registers as the A fragments of P V (4 k-steps x 4 n-tiles).
// - Head dim 32 only (Swin-T, -B and -L); the wrapper raises otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 32;        // head dim
constexpr int ROWS = 64;     // tokens per window, padded
constexpr int LDQ = D + 8;   // bf16 row stride of sQ and sK
constexpr int LDV = ROWS + 8;  // bf16 row stride of sVt (v transposed)
constexpr int NTHREADS = 128;

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

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(NTHREADS)
    window_attention_kernel(const bf16* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            bf16* __restrict__ out, int n, int heads, int C,
                            int nW, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + ROWS * LDQ;
  bf16* sVt = sK + ROWS * LDQ;
  float* sBias = reinterpret_cast<float*>(sVt + D * LDV);
  float* sMask = sBias + n * n;

  const int w = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nn = n * n;
  const size_t ld = 3 * static_cast<size_t>(C);
  const bf16* base = qkv + static_cast<size_t>(w) * n * ld;

  if (mask != nullptr) {
    const float* mrow = mask + static_cast<size_t>(w % nW) * nn;
    for (int i = tid; i < nn; i += NTHREADS) sMask[i] = mrow[i];
  }

  const int r0 = warp * 16;
  const int ra = r0 + g, rb = ra + 8;  // this lane's two query rows

  for (int h = 0; h < heads; ++h) {
    __syncthreads();  // the previous head is done with shared memory
    // q and k: 64 rows x 4 chunks of 8 bf16; v transposed into sVt.
    for (int i = tid; i < ROWS * 4; i += NTHREADS) {
      const int r = i >> 2, c = (i & 3) * 8;
      uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q;
      if (r < n) {
        const bf16* row = base + r * ld + h * D + c;
        q = *reinterpret_cast<const uint4*>(row);
        k = *reinterpret_cast<const uint4*>(row + C);
        v = *reinterpret_cast<const uint4*>(row + 2 * C);
      }
      *reinterpret_cast<uint4*>(sQ + r * LDQ + c) = q;
      *reinterpret_cast<uint4*>(sK + r * LDQ + c) = k;
      const bf16* ve = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(c + e) * LDV + r] = ve[e];
    }
    const float* bh = bias + static_cast<size_t>(h) * nn;
    for (int i = tid; i < nn; i += NTHREADS) sBias[i] = bh[i];
    __syncthreads();
    if (r0 >= n) continue;  // all 16 rows of this warp are padding

    // ---- S = Q K^T, 16 rows x 64 columns per warp.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      a[0] = lds32(sQ + ra * LDQ + kk + 2 * t);
      a[1] = lds32(sQ + rb * LDQ + kk + 2 * t);
      a[2] = lds32(sQ + ra * LDQ + kk + 2 * t + 8);
      a[3] = lds32(sQ + rb * LDQ + kk + 2 * t + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kr = sK + (j * 8 + g) * LDQ + kk + 2 * t;
        mma_bf16(s[j], a, lds32(kr), lds32(kr + 8));
      }
    }

    // ---- scale, bias, mask; -inf beyond n; f32 row softmax.
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb;
        const int col = j * 8 + 2 * t + (e & 1);
        float v = -INFINITY;
        if (col < n) {
          v = s[j][e] * scale;
          if (row < n) {
            v = v + sBias[row * n + col];
            if (mask != nullptr) v = v + sMask[row * n + col];
          }
        }
        s[j][e] = v;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mx_a);
      s[j][1] = expf(s[j][1] - mx_a);
      s[j][2] = expf(s[j][2] - mx_b);
      s[j][3] = expf(s[j][3] - mx_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
    }

    // ---- ctx = P V: P's accumulator layout is the A fragment layout.
    float o[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack2(s[2 * kk][0] / sum_a, s[2 * kk][1] / sum_a);
      a[1] = pack2(s[2 * kk][2] / sum_b, s[2 * kk][3] / sum_b);
      a[2] = pack2(s[2 * kk + 1][0] / sum_a, s[2 * kk + 1][1] / sum_a);
      a[3] = pack2(s[2 * kk + 1][2] / sum_b, s[2 * kk + 1][3] / sum_b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* vr = sVt + (j * 8 + g) * LDV + kk * 16 + 2 * t;
        mma_bf16(o[j], a, lds32(vr), lds32(vr + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = h * D + j * 8 + 2 * t;
      if (ra < n)
        *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(w) * n + ra) * C + col) =
            pack2(o[j][0], o[j][1]);
      if (rb < n)
        *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(w) * n + rb) * C + col) =
            pack2(o[j][2], o[j][3]);
    }
  }
}

}  // namespace

// Launch the window attention of Bw windows on `stream`: qkv (Bw, n, 3C) and
// out (Bw, n, C) bf16, bias (heads, n, n) f32, mask (nW, n, n) f32 or null.
// The wrapper (ops/window_attention.py) has checked n <= 64, C == 32 * heads,
// types and contiguity.  Returns the CUDA error code of the launch.
extern "C" int mc3d_window_attention(const void* qkv, const void* bias,
                                     const void* mask, void* out, int Bw, int n,
                                     int heads, int C, int nW, void* stream) {
  if (n > ROWS || C != heads * D || Bw <= 0 || nW <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(bf16) * (2 * ROWS * LDQ + D * LDV) +
                      sizeof(float) * 2 * static_cast<size_t>(n) * n;
  // d^-1/2 rounded once to f32, as the plain version's Python float is.
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  window_attention_kernel<<<Bw, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out), n, heads, C, nW,
      scale);
  return static_cast<int>(cudaGetLastError());
}
