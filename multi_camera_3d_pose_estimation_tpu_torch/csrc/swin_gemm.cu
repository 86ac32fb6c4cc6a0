// The four token products of a SwinBlock on Hopper (sm_90a), bf16 in and out.
//
// Replaces, with csrc/window_attention.cu, the JAX package's
// ops/pallas/swin_block.py::fused_swin_block (its _block_body).  A block is
// five launches: three modes of this GEMM around the attention kernel.
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
// of the 786,432 real tokens at stage 0 (of 878,080 window tokens), 196,608
// at stage 1, 49,152 at stage 2 and 12,288 at stage 3: 0.31 TFLOP at every
// stage.  With the attention's 4 * n * C per real query a block is
// 0.31-0.33 TFLOP, 0.32-0.33 ms at 989 TFLOP/s, against at most 0.40 GB of
// tokens read and written (0.12 ms at 3.35 TB/s, stage 0): bound by
// operations at every stage.  All 24 backbone blocks are 7.6 TFLOP,
// 7.66 ms (chip_smoke.py computes these bounds from the run's shapes).
// The design does what it can for both: the LayerNorms are folded into
// the A-tile loads (a statistics pass over the CTA's rows, then each tile
// is normalized on its way to shared memory: no LN pass over device
// memory), and the bias, residual, GELU and valid mask are applied to the
// accumulators before the one store.
//
// Design (simple first, not yet fast):
// - CTA tile 128 x 128 x 32, 8 warps as 2 x 4, each warp 64 x 32 of
//   mma.sync m16n8k16 (bf16 -> f32).  Grid (N tiles, M tiles): the CTAs that
//   share A rows run next to each other and share them in L2.
// - Two shared-memory stages.  W tiles (and A tiles without LN) arrive by
//   cp.async; LN A tiles are loaded into registers one step ahead,
//   normalized and stored after the current step's products.  Shared rows
//   are padded by 8 bf16 so fragment loads are free of bank conflicts.
// - Rows beyond M and W rows beyond N are zero-filled; N % 8 == 0 and
//   K % 32 == 0 (the wrapper checks).  wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { MODE_LN_QKV = 0, MODE_RESID = 1, MODE_LN_GELU = 2 };

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // bf16 row stride of the shared tiles
constexpr int NTHREADS = 256;
constexpr int MAX_M_TILES = 65535;  // gridDim.y limit: M <= 65535 * 128 rows

struct Params {
  const bf16* A;
  const bf16* W;
  const float* bias;
  const bf16* res;
  const float* ln_w;
  const float* ln_b;
  const float* valid;
  bf16* out;
  int M, N, K, period;
  float eps;
};

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

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return make_float2(__low2float(v), __high2float(v));
}

__device__ __forceinline__ float bf(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS) swin_gemm_kernel(Params p) {
  constexpr bool LN = MODE != MODE_RESID;
  __shared__ __align__(16) bf16 sA[2][BM * LDS];
  __shared__ __align__(16) bf16 sB[2][BN * LDS];
  __shared__ float sMu[BM], sRs[BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows 64*wm, cols 32*wn
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = p.M, N = p.N, K = p.K;
  const int KT = K / BK;

  // Each thread moves chunks tid and tid + 256 of a 128 x 32 tile
  // (row = chunk / 4, column = (chunk % 4) * 8).
  int crow[2], ccol[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    crow[c] = (tid + c * NTHREADS) >> 2;
    ccol[c] = ((tid + c * NTHREADS) & 3) * 8;
  }

  // ---- LN statistics of the CTA's rows: one warp per row.
  if (LN) {
    for (int r = warp; r < BM; r += NTHREADS / 32) {
      const int row = m0 + r;
      float s = 0.f, s2 = 0.f;
      if (row < M) {
        const bf16* a = p.A + static_cast<size_t>(row) * K;
        for (int k = lane * 8; k < K; k += 256) {
          const uint4 u = *reinterpret_cast<const uint4*>(a + k);
          const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack2(w4[e]);
            s += f.x + f.y;
            s2 += f.x * f.x + f.y * f.y;
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (lane == 0) {
        const float mu = s / K;
        sMu[r] = mu;
        sRs[r] = rsqrtf(s2 / K - mu * mu + p.eps);
      }
    }
    __syncthreads();
  }

  uint4 areg[2];  // LN: the next A tile's raw chunks
  auto load_a_regs = [&](int kt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = m0 + crow[c];
      areg[c] = make_uint4(0, 0, 0, 0);
      if (row < M)
        areg[c] = *reinterpret_cast<const uint4*>(p.A + static_cast<size_t>(row) * K +
                                                  kt * BK + ccol[c]);
    }
  };
  auto store_a_normalized = [&](int kt, int buf) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = crow[c], row = m0 + r, k = kt * BK + ccol[c];
      uint4 o = make_uint4(0, 0, 0, 0);
      if (row < M) {
        const float mu = sMu[r], rs = sRs[r];
        const float vm = p.valid ? p.valid[row % p.period] : 1.f;
        const uint32_t w4[4] = {areg[c].x, areg[c].y, areg[c].z, areg[c].w};
        uint32_t y4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack2(w4[e]);
          const int kk = k + 2 * e;
          const float y0 = ((f.x - mu) * rs * p.ln_w[kk] + p.ln_b[kk]) * vm;
          const float y1 = ((f.y - mu) * rs * p.ln_w[kk + 1] + p.ln_b[kk + 1]) * vm;
          y4[e] = pack2(y0, y1);
        }
        o = make_uint4(y4[0], y4[1], y4[2], y4[3]);
      }
      *reinterpret_cast<uint4*>(&sA[buf][r * LDS + ccol[c]]) = o;
    }
  };
  auto fetch_b = [&](int kt, int buf) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int nrow = n0 + crow[c];
      const bf16* src = p.W + static_cast<size_t>(nrow < N ? nrow : 0) * K + kt * BK + ccol[c];
      cp_async16(&sB[buf][crow[c] * LDS + ccol[c]], src, nrow < N);
    }
  };
  auto fetch_a = [&](int kt, int buf) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = m0 + crow[c];
      const bf16* src = p.A + static_cast<size_t>(row < M ? row : 0) * K + kt * BK + ccol[c];
      cp_async16(&sA[buf][crow[c] * LDS + ccol[c]], src, row < M);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // Stage 0.
  fetch_b(0, 0);
  if (LN) {
    load_a_regs(0);
    store_a_normalized(0, 0);
  } else {
    fetch_a(0, 0);
  }
  cp_async_commit();

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) {
      fetch_b(kt + 1, cur ^ 1);
      if (LN)
        load_a_regs(kt + 1);
      else
        fetch_a(kt + 1, cur ^ 1);
    }
    cp_async_commit();
    cp_async_wait1();  // the group of step kt has landed
    __syncthreads();

    const bf16* a_s = sA[cur];
    const bf16* b_s = sB[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t bfr[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* br = b_s + (wn * 32 + j * 8 + g) * LDS + kk + 2 * t;
        bfr[j][0] = lds32(br);
        bfr[j][1] = lds32(br + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* ar = a_s + (wm * 64 + i * 16 + g) * LDS + kk + 2 * t;
        uint32_t a[4];
        a[0] = lds32(ar);
        a[1] = lds32(ar + 8 * LDS);
        a[2] = lds32(ar + 8);
        a[3] = lds32(ar + 8 * LDS + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, bfr[j][0], bfr[j][1]);
      }
    }
    // LN: the next A tile goes into the other stage, which every warp
    // finished reading before this step's barrier.
    if (LN && kt + 1 < KT) store_a_normalized(kt + 1, cur ^ 1);
    __syncthreads();
  }

  // ---- Epilogue.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * 64 + i * 16 + g + hr * 8;
      if (row >= M) continue;
      float vm = 1.f;
      if (MODE == MODE_RESID && p.valid) vm = p.valid[row % p.period];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        if (col >= N) continue;
        const float c0 = acc[i][j][2 * hr], c1 = acc[i][j][2 * hr + 1];
        const float b0 = p.bias[col], b1 = p.bias[col + 1];
        const size_t at = static_cast<size_t>(row) * N + col;
        uint32_t o;
        if (MODE == MODE_LN_QKV) {
          o = pack2(bf(c0) + bf(b0), bf(c1) + bf(b1));
        } else if (MODE == MODE_RESID) {
          const float2 r = unpack2(*reinterpret_cast<const uint32_t*>(p.res + at));
          const float y0 = bf(r.x + bf(bf(c0) + bf(b0))) * vm;
          const float y1 = bf(r.y + bf(bf(c1) + bf(b1))) * vm;
          o = pack2(y0, y1);
        } else {
          const float h0 = c0 + b0, h1 = c1 + b1;
          o = pack2(0.5f * h0 * (1.f + erff(h0 * 0.70710677f)),
                    0.5f * h1 * (1.f + erff(h1 * 0.70710677f)));
        }
        *reinterpret_cast<uint32_t*>(p.out + at) = o;
      }
    }
  }
}

}  // namespace

// Launch one Swin token product on `stream` (mode: 0 LN->qkv, 1 residual,
// 2 LN->fc1->GELU).  A (M, K), W (N, K), res and out (M, N) bf16; bias (N),
// ln_w/ln_b (K) and valid (period) f32; res, ln_* and valid may be null where
// the mode does not read them.  The wrapper (ops/swin_block.py) has checked
// N % 8 == 0, K % 32 == 0, types, contiguity and 16-byte alignment.
// Returns the CUDA error code of the launch.
extern "C" int mc3d_swin_gemm(int mode, const void* A, const void* W, const void* bias,
                              const void* res, const void* ln_w, const void* ln_b,
                              const void* valid, void* out, int M, int N, int K,
                              int period, float eps, void* stream) {
  if (M <= 0 || N % 8 || K % BK || (valid && period <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((M + BM - 1) / BM > MAX_M_TILES) return static_cast<int>(cudaErrorInvalidConfiguration);
  Params p;
  p.A = static_cast<const bf16*>(A);
  p.W = static_cast<const bf16*>(W);
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const bf16*>(res);
  p.ln_w = static_cast<const float*>(ln_w);
  p.ln_b = static_cast<const float*>(ln_b);
  p.valid = static_cast<const float*>(valid);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.period = period;
  p.eps = eps;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_LN_QKV:
      swin_gemm_kernel<MODE_LN_QKV><<<grid, NTHREADS, 0, s>>>(p);
      break;
    case MODE_RESID:
      swin_gemm_kernel<MODE_RESID><<<grid, NTHREADS, 0, s>>>(p);
      break;
    case MODE_LN_GELU:
      swin_gemm_kernel<MODE_LN_GELU><<<grid, NTHREADS, 0, s>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
