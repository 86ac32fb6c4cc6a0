// Single-pass heatmap decode on Hopper (sm_90a): one read of each map.
//
// Replaces ops/pallas/fused_decode.py::fused_heatmap_decode (_decode_kernel)
// of the JAX package.  For each of N heatmaps of H*W f32 values it writes
// 12 f32 values:
//   [0..5]  thresholded raw moments  sum v, v*x, v*y, v*x*x, v*x*y, v*y*y
//           with v = (h < threshold ? 0 : h), x = i % W, y = i / W
//   [6]     peak (max of the raw map)
//   [7]     first-occurrence argmax (row-major linear index, as a float)
//   [8..11] the raw map at the argmax's right, left, lower and upper
//           neighbours, coordinates clamped to the map
// The finishing arithmetic (means, covariances, the +-0.25 shift) is plain
// torch on the (N, 12) result (ops/fused_decode.py).
//
// Bound at the headline (512 crops x 17 joints of 64x48): 107 MB read, a
// few hundred KB written, about 32 us at 3.35 TB/s; the arithmetic is
// ~10 flops per element, so the kernel is bound by bytes.
//
// Design: one CTA of 128 threads per map.  Each thread walks the map in
// float4 steps (coalesced 16-byte loads; H*W % 4 == 0 is required), keeps
// its six partial sums and its (peak, first index) in registers, and the
// CTA reduces with warp shuffles and a small shared array.  Ties in the
// argmax break to the smaller index, as jnp.argmax does.  The four
// neighbour values are read back by one thread (L1/L2-resident).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

// Keep (v, i) if it beats (bv, bi): larger value, or equal value, smaller index.
__device__ __forceinline__ void arg_better(float v, int i, float& bv, int& bi) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__global__ void __launch_bounds__(NTHREADS) decode_kernel(const float* __restrict__ hm,
                                                          float* __restrict__ out, int HW,
                                                          int W, float threshold) {
  const float* map = hm + static_cast<size_t>(blockIdx.x) * HW;
  const float4* map4 = reinterpret_cast<const float4*>(map);
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;

  for (int q = threadIdx.x; q < HW / 4; q += NTHREADS) {
    const float4 v4 = __ldg(map4 + q);
    const float vals[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * q + e;
      const float h = vals[e];
      const float x = static_cast<float>(i % W);
      const float y = static_cast<float>(i / W);
      const float v = h < threshold ? 0.f : h;
      const float vx = v * x, vy = v * y;
      s[0] += v;
      s[1] += vx;
      s[2] += vy;
      s[3] += vx * x;
      s[4] += vx * y;
      s[5] += vy * y;
      arg_better(h, i, best, best_i);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    arg_better(ov, oi, best, best_i);
  }

  __shared__ float ss[NWARPS][6];
  __shared__ float sb[NWARPS];
  __shared__ int si[NWARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) ss[warp][k] = s[k];
    sb[warp] = best;
    si[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  float t[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  best = -CUDART_INF_F;
  best_i = 0x7fffffff;
  for (int w = 0; w < NWARPS; ++w) {
#pragma unroll
    for (int k = 0; k < 6; ++k) t[k] += ss[w][k];
    arg_better(sb[w], si[w], best, best_i);
  }
  if (best_i == 0x7fffffff) best_i = 0;  // all-NaN map: index 0, as a guard
  const int H = HW / W;
  const int ax = best_i % W, ay = best_i / W;
  float* o = out + static_cast<size_t>(blockIdx.x) * 12;
#pragma unroll
  for (int k = 0; k < 6; ++k) o[k] = t[k];
  o[6] = best;
  o[7] = static_cast<float>(best_i);
  o[8] = map[ay * W + min(ax + 1, W - 1)];
  o[9] = map[ay * W + max(ax - 1, 0)];
  o[10] = map[min(ay + 1, H - 1) * W + ax];
  o[11] = map[max(ay - 1, 0) * W + ax];
}

}  // namespace

// Decode N contiguous f32 maps of HW values (rows of width W) into out
// (N, 12) f32 on `stream`.  Returns the CUDA error code of the launch.
// The wrapper (ops/fused_decode.py) has checked shapes, type, contiguity
// and HW % 4 == 0.
extern "C" int mc3d_heatmap_decode(const void* hm, void* out, int N, int HW, int W,
                                   float threshold, void* stream) {
  if (N == 0) return 0;
  decode_kernel<<<N, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hm), static_cast<float*>(out), HW, W, threshold);
  return static_cast<int>(cudaGetLastError());
}
