// The eval-mode BatchNorm epilogue of a conv on Hopper (sm_90a): BatchNorm
// in f32, the bf16 cast, an optional residual (or FuseLayer) sum with an
// optional nearest upsample, and an optional ReLU, in one pass.
//
// Replaces no TPU kernel.  The JAX package leaves HRNet's BatchNorm to
// XLA, which fuses it into the conv; the port's plain path
// (ops/bn_epilogue.py::bn_epilogue_plain) makes one pass over the map for
// each of bf16 -> f32, - mean, * mul, + bias, f32 -> bf16, the upsample,
// the add and the ReLU.
//
// For a conv output y (N, C, Hy, Wy) bf16 and per-channel f32 vectors
// mean, mul = rsqrt(var + eps) * gamma and bias, each output element
// (n, c, h, w) of out (N, C, Hy << s, Wy << s) bf16 is
//   b = bf16((f32(y[n, c, h >> s, w >> s]) - mean[c]) * mul[c] + bias[c])
//   v = bf16(f32(r[n, c, h, w]) + f32(b))      with a residual r, else b
//   out = v < 0 ? 0 : v                         with relu, else v
// with every f32 step rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn:
// no contraction into an FMA) and round-to-nearest-even casts, so the
// output equals the plain path's bit for bit; the ReLU may give +0 where
// the plain path gives -0.  h >> s is F.interpolate(mode="nearest") at the
// integer factor 2^s.
//
// y, r and out are dense in one layout: channels-last (NHWC in memory) or
// NCHW-contiguous.
//
// Bound: bytes.  The pass reads y once (in the upsample mode each y value
// is read 4^s times, from L2) and r once, and writes out once.
//
// Design: a grid-stride loop over groups of VEC outputs in memory order,
// enough CTAs of 256 threads to fill every SM.  VEC = 8 (one 16-byte load
// of y and of r, one 16-byte store) where a group lies in one pixel's
// channels (channels-last, C % 8 == 0) or one channel's plane (NCHW,
// H * W % 8 == 0, no upsample) and the pointers are 16-byte aligned; else
// VEC = 1.  The three vectors sit in shared memory, loaded once per CTA.
// Index arithmetic is 32-bit below 2^31 outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per CTA
constexpr int CTAS_PER_SM = 8;    // 2048 threads: full occupancy
constexpr int MAX_C = 4096;       // 48 KB of vectors in shared memory

struct Args {
  const __nv_bfloat16* y;
  const __nv_bfloat16* r;  // null: no residual
  __nv_bfloat16* out;
  const float* mean;
  const float* mul;
  const float* bias;
  int C, Ho, Wo, shift, relu;
};

__device__ __forceinline__ float bf16_bits_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_bits_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = bf16_bits_lo(w[k]);
      v[2 * k + 1] = bf16_bits_hi(w[k]);
    }
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]))) |
             (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1])))
              << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// I: the index type (uint32_t where every offset fits, else uint64_t).
template <bool CL, int VEC, typename I>
__global__ void __launch_bounds__(NT) bn_epilogue_kernel(Args a, I n_groups) {
  extern __shared__ float s_vec[];  // mean[C], mul[C], bias[C]
  float* s_mean = s_vec;
  float* s_mul = s_vec + a.C;
  float* s_bias = s_vec + 2 * a.C;
  for (int c = threadIdx.x; c < a.C; c += NT) {
    s_mean[c] = a.mean[c];
    s_mul[c] = a.mul[c];
    s_bias[c] = a.bias[c];
  }
  __syncthreads();

  const I C = a.C, Ho = a.Ho, Wo = a.Wo, HWo = Ho * Wo;
  const int s = a.shift;
  const I Hy = Ho >> s, Wy = Wo >> s;
  for (I g = static_cast<I>(blockIdx.x) * NT + threadIdx.x; g < n_groups;
       g += static_cast<I>(gridDim.x) * NT) {
    const I e = g * VEC;  // the group's first output element, in memory order
    I c, yo;              // its channel; the offset of its y element
    if constexpr (CL) {
      const I pix = e / C;
      c = e - pix * C;
      if (s == 0) {
        yo = e;
      } else {
        const I n = pix / HWo, hw = pix - n * HWo, h = hw / Wo, w = hw - h * Wo;
        yo = ((n * Hy + (h >> s)) * Wy + (w >> s)) * C + c;
      }
    } else {
      const I nc = e / HWo;
      c = nc % C;
      if (s == 0) {
        yo = e;
      } else {
        const I hw = e - nc * HWo, h = hw / Wo, w = hw - h * Wo;
        yo = (nc * Hy + (h >> s)) * Wy + (w >> s);
      }
    }
    float v[VEC];
    load<VEC>(a.y + yo, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int cj = static_cast<int>(c) + (CL ? j : 0);
      v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], s_mean[cj]), s_mul[cj]), s_bias[cj]);
    }
    if (a.r != nullptr) {
      float r[VEC];
      load<VEC>(a.r + e, r);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        v[j] = __fadd_rn(r[j], __bfloat162float(__float2bfloat16_rn(v[j])));
    }
    if (a.relu) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = v[j] < 0.f ? 0.f : v[j];  // NaN stays NaN
    }
    store<VEC>(a.out + e, v);
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

template <bool CL, int VEC, typename I>
int launch(const Args& a, uint64_t n_out, cudaStream_t stream) {
  const uint64_t groups = n_out / VEC;
  const uint64_t want = (groups + NT - 1) / NT;
  const uint64_t most = static_cast<uint64_t>(sm_count()) * CTAS_PER_SM;
  const unsigned grid = static_cast<unsigned>(want < most ? want : most);
  const size_t smem = static_cast<size_t>(a.C) * 3 * sizeof(float);
  bn_epilogue_kernel<CL, VEC, I><<<grid, NT, smem, stream>>>(a, static_cast<I>(groups));
  return static_cast<int>(cudaGetLastError());
}

template <bool CL, int VEC>
int launch_index(const Args& a, uint64_t n_out, cudaStream_t stream) {
  // Every offset is below n_out (y has at most as many elements as out), and
  // the grid-stride index stays below 2^32 while n_out < 2^31.
  return n_out < (1ull << 31) ? launch<CL, VEC, uint32_t>(a, n_out, stream)
                              : launch<CL, VEC, uint64_t>(a, n_out, stream);
}

}  // namespace

// out (N, C, Ho, Wo) bf16 from y (N, C, Ho >> shift, Wo >> shift) bf16, as
// above, on `stream`; r null or (N, C, Ho, Wo) bf16; mean, mul, bias (C,)
// f32 contiguous.  y, r and out dense in one layout: channels-last when
// channels_last, else NCHW-contiguous.  vec: the wrapper found 8-element
// groups valid (see the design note) and y, r and out 16-byte aligned.
// Returns the CUDA error code of the launch (cudaErrorInvalidValue for
// C > 4096).  The wrapper (ops/bn_epilogue.py) has checked shapes, types,
// layouts and devices.
extern "C" int mc3d_bn_epilogue(const void* y, const void* r, void* out, const void* mean,
                                const void* mul, const void* bias, int N, int C, int Ho,
                                int Wo, int shift, int channels_last, int vec, int relu,
                                void* stream) {
  const uint64_t n_out = static_cast<uint64_t>(N) * C * Ho * Wo;
  if (n_out == 0) return 0;
  if (C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(r),
         static_cast<__nv_bfloat16*>(out), static_cast<const float*>(mean),
         static_cast<const float*>(mul), static_cast<const float*>(bias), C, Ho, Wo, shift,
         relu};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (channels_last)
    return vec ? launch_index<true, 8>(a, n_out, st) : launch_index<true, 1>(a, n_out, st);
  return vec ? launch_index<false, 8>(a, n_out, st) : launch_index<false, 1>(a, n_out, st);
}
