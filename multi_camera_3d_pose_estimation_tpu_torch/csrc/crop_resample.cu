// Crop, antialiased linear resample and ImageNet normalize on Hopper
// (sm_90a): one pass over the frames.
//
// Replaces no TPU kernel.  The JAX package crops with
// jax.image.scale_and_translate(method="linear") under XLA, and the port's
// plain form (ops/crop_resample.py::crop_frames + the normalize) builds
// dense per-box (out, in) weight matrices and applies them as two batched
// products, the second of which broadcasts its weights and copies them,
// (B, out_h, out_w, W) of them, every call.  This kernel computes the same
// function from each box's few non-zero taps.
//
// For each box b (x0, y0, x1, y1) f32 and frames (B, H, W, 3) bf16 or f32:
//   - the box padded by `padding` and fitted to the aspect out_w / out_h
//     about its centre, as center_scale_from_bbox, in f32 with the CPU's
//     roundings (true division, no contraction): card and CPU give the
//     same scale (B, 2) = out / size and offset (B, 2) = the window's x0, y0;
//   - per output sample o of an axis of n inputs: e = (o + 0.5)/s - t/s - 0.5
//     (t = -origin * s), kernel width k = max(1/s, 1), raw weights
//     max(0, 1 - |e - i| / k) over the in-image taps i in
//     [floor(e - k), ceil(e + k)], scaled by 1 / their sum; all zero where
//     the sum is not above 1000 * eps_f32 or e lies outside [-0.5, n - 0.5];
//   - the separable resample with f32 sums (nothing rounded between the two
//     axes), then (v - mean[c]) / std[c] in f32 and one rounding to the
//     frames' dtype; crops (B, out_h, out_w, 3).
// The weights are computed as 1 - |e - i| * (1/k) and normalized after the
// sums: within a few f32 ulps of the plain form's.
//
// Bound: bytes.  A block of HRNet-W32's benchmark reads 512 bf16 VGA frames
// (944 MB) and writes 512 crops of 256x192x3 (151 MB): 0.33 ms at
// 3.35 TB/s.  The arithmetic is ~10 taps per output per axis on CUDA cores.
//
// Design: one CTA of 256 threads per (box, TH output rows).  The CTA lays
// out its box's column taps in shared memory once.  For each of its output
// rows that has weight, it sums the row's input rows (taps in groups of
// TAPG, weights in shared memory) into an f32 row in shared memory, reading
// the frames in coalesced 16-byte vectors; then each thread resamples its
// outputs along x from that row, normalizes, rounds and stores (coalesced).
// Rows wider than CAPC columns go in chunks, so shared memory grows with
// out_w only (12 KB + 28 B per output column).  Output rows outside the
// frame are the constant -mean/std.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int NT = 256;     // threads per CTA
constexpr int TH = 8;       // output rows per CTA
constexpr int TAPG = 32;    // row taps per group
constexpr int CAPC = 1024;  // input columns per chunk (a multiple of 8)
constexpr float MIN_TOTAL = 1000.f * 1.1920928955078125e-7f;  // 1000 * eps_f32

__device__ __forceinline__ float imagenet_mean(int c) {
  return c == 0 ? 0.485f : (c == 1 ? 0.456f : 0.406f);
}
__device__ __forceinline__ float imagenet_std(int c) {
  return c == 0 ? 0.229f : (c == 1 ? 0.224f : 0.225f);
}

// torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// One axis of one box: _weight_mat(n, out, s, -origin * s).
struct Axis {
  float inv;     // 1 / s
  float ks;      // max(1 / s, 1)
  float inv_ks;  // 1 / ks
  float t_inv;   // (-origin * s) / s
  int n;         // inputs
};

__device__ __forceinline__ Axis make_axis(float s, float origin, int n) {
  Axis a;
  a.inv = __frcp_rn(s);
  a.ks = fmaxf(a.inv, 1.f);
  a.inv_ks = __frcp_rn(a.ks);
  a.t_inv = __fmul_rn(__fmul_rn(-origin, s), a.inv);
  a.n = n;
  return a;
}

__device__ __forceinline__ float sample_at(const Axis& a, int o) {
  return __fsub_rn(__fsub_rn(__fmul_rn(static_cast<float>(o) + 0.5f, a.inv), a.t_inv), 0.5f);
}

__device__ __forceinline__ float tap(const Axis& a, float e, int i) {
  return fmaxf(0.f, 1.f - fabsf(e - static_cast<float>(i)) * a.inv_ks);
}

// The taps [lo, hi] of the output at e and 1 / the sum of their weights;
// lo > hi and 0 where the output has no weight.
__device__ __forceinline__ float taps(const Axis& a, float e, int& lo, int& hi) {
  lo = 1;
  hi = 0;
  if (!(e >= -0.5f && e <= static_cast<float>(a.n) - 0.5f)) return 0.f;
  const int l = max(0, __float2int_rd(e - a.ks));
  const int h = min(a.n - 1, __float2int_ru(e + a.ks));
  float total = 0.f;
  for (int i = l; i <= h; ++i) total += tap(a, e, i);
  if (!(total > MIN_TOTAL)) return 0.f;
  lo = l;
  hi = h;
  return __frcp_rn(total);
}

template <typename T>
struct Pix;

template <>
struct Pix<float> {
  static constexpr int VEC = 4;  // elements per 16-byte load
  __device__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static float one(const float* p) { return __ldg(p); }
  __device__ static float store(float v) { return v; }
};

template <>
struct Pix<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static float one(const __nv_bfloat16* p) { return __bfloat162float(p[0]); }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

template <typename T>
__global__ void __launch_bounds__(NT) crop_kernel(
    const T* __restrict__ frames, const float* __restrict__ boxes, T* __restrict__ out,
    float* __restrict__ scale_out, float* __restrict__ offset_out, int H, int W, int out_h,
    int out_w, float padding, float aspect, int tiles, int capc, int vec_ok) {
  constexpr int VEC = Pix<T>::VEC;
  extern __shared__ float4 smem4[];
  float* s_row = reinterpret_cast<float*>(smem4);  // capc * 3: one row chunk, f32
  float* s_acc = s_row + capc * 3;                 // out_w * 3: the output row's sums
  float* s_xe = s_acc + out_w * 3;                 // out_w: column sample positions
  float* s_xn = s_xe + out_w;                      // out_w: 1 / column weight sums (0: none)
  int* s_xlo = reinterpret_cast<int*>(s_xn + out_w);
  int* s_xhi = s_xlo + out_w;
  __shared__ float s_wy[TAPG];
  __shared__ int s_span[2];

  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int tid = threadIdx.x;

  // The box, as center_scale_from_bbox and crop_frames compute it on the CPU.
  const float bx0 = boxes[4 * b], by0 = boxes[4 * b + 1];
  const float bx1 = boxes[4 * b + 2], by1 = boxes[4 * b + 3];
  const float cx = __fmul_rn(__fadd_rn(bx0, bx1), 0.5f);
  const float cy = __fmul_rn(__fadd_rn(by0, by1), 0.5f);
  const float w = __fmul_rn(__fsub_rn(bx1, bx0), padding);
  const float h = __fmul_rn(__fsub_rn(by1, by0), padding);
  const float w_fit = nan_max(w, __fmul_rn(h, aspect));
  const float h_fit = nan_max(h, __fdiv_rn(w, aspect));
  const float ox0 = __fsub_rn(cx, __fmul_rn(w_fit, 0.5f));
  const float oy0 = __fsub_rn(cy, __fmul_rn(h_fit, 0.5f));
  const float sx = __fmul_rn(__frcp_rn(w_fit), static_cast<float>(out_w));
  const float sy = __fmul_rn(__frcp_rn(h_fit), static_cast<float>(out_h));
  if (tile == 0 && tid == 0) {
    scale_out[2 * b] = sx;
    scale_out[2 * b + 1] = sy;
    offset_out[2 * b] = ox0;
    offset_out[2 * b + 1] = oy0;
  }
  const Axis ax = make_axis(sx, ox0, W);
  const Axis ay = make_axis(sy, oy0, H);

  // Column taps, once per CTA; [xa, xb] spans every column with weight.
  if (tid == 0) {
    s_span[0] = INT_MAX;
    s_span[1] = -1;
  }
  __syncthreads();
  for (int o = tid; o < out_w; o += NT) {
    const float e = sample_at(ax, o);
    int lo, hi;
    s_xn[o] = taps(ax, e, lo, hi);
    s_xe[o] = e;
    s_xlo[o] = lo;
    s_xhi[o] = hi;
    if (lo <= hi) {
      atomicMin(&s_span[0], lo);
      atomicMax(&s_span[1], hi);
    }
  }
  __syncthreads();
  const int xa = s_span[0] & ~7;  // chunks start on 8-column (16-byte) boundaries
  const int xb = min(W, (s_span[1] + 8) & ~7);
  const size_t row_elems = static_cast<size_t>(W) * 3;
  const int n_out = out_w * 3;

  const int oy_end = min(out_h, (tile + 1) * TH);
  for (int oy = tile * TH; oy < oy_end; ++oy) {
    T* orow = out + (static_cast<size_t>(b) * out_h + oy) * n_out;
    const float ey = sample_at(ay, oy);
    int ry0, ry1;
    const float ny = taps(ay, ey, ry0, ry1);
    if (ry0 > ry1 || xa >= xb) {  // no weight: every output is (0 - mean) / std
      for (int q = tid; q < n_out; q += NT) {
        const int c = q % 3;
        orow[q] = Pix<T>::store(__fdiv_rn(-imagenet_mean(c), imagenet_std(c)));
      }
      continue;
    }
    for (int c0 = xa; c0 < xb; c0 += capc) {
      const int c1 = min(xb, c0 + capc);
      const int nel = (c1 - c0) * 3;
      const T* chunk = frames + static_cast<size_t>(b) * H * row_elems + c0 * 3;
      // Along y: the chunk of the output row, in f32, into s_row.
      for (int g0 = ry0; g0 <= ry1; g0 += TAPG) {
        const int ng = min(TAPG, ry1 - g0 + 1);
        __syncthreads();  // s_wy free
        if (tid < ng) s_wy[tid] = tap(ay, ey, g0 + tid);
        __syncthreads();
        const T* rows = chunk + static_cast<size_t>(g0) * row_elems;
        for (int v = tid * VEC; v < nel; v += NT * VEC) {
          float acc[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = g0 == ry0 ? 0.f : s_row[v + j];
          if (vec_ok) {
#pragma unroll 4
            for (int k = 0; k < ng; ++k) {
              float px[VEC];
              Pix<T>::load(rows + k * row_elems + v, px);
              const float wk = s_wy[k];
#pragma unroll
              for (int j = 0; j < VEC; ++j) acc[j] = fmaf(wk, px[j], acc[j]);
            }
          } else {
            for (int k = 0; k < ng; ++k) {
              const float wk = s_wy[k];
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                if (v + j < nel) acc[j] = fmaf(wk, Pix<T>::one(rows + k * row_elems + v + j), acc[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            if (v + j < nel) s_row[v + j] = acc[j];
        }
      }
      __syncthreads();  // s_row complete
      // Along x: each thread's outputs q = ox * 3 + c from the chunk's taps.
      for (int q = tid; q < n_out; q += NT) {
        const int o = q / 3, c = q - 3 * (q / 3);
        const int lo = max(s_xlo[o], c0), hi = min(s_xhi[o], c1 - 1);
        const float e = s_xe[o];
        float sum = 0.f;
        for (int i = lo; i <= hi; ++i) sum = fmaf(tap(ax, e, i), s_row[(i - c0) * 3 + c], sum);
        s_acc[q] = c0 == xa ? sum : s_acc[q] + sum;
      }
      __syncthreads();  // s_row free for the next chunk or row
    }
    // Normalize and store: each thread its own outputs of s_acc.
    for (int q = tid; q < n_out; q += NT) {
      const int o = q / 3, c = q - 3 * (q / 3);
      const float v = s_acc[q] * ny * s_xn[o];
      orow[q] = Pix<T>::store(__fdiv_rn(__fsub_rn(v, imagenet_mean(c)), imagenet_std(c)));
    }
  }
}

template <typename T>
int launch(const void* frames, const void* boxes, void* out, void* scale, void* offset, int B,
           int H, int W, int out_h, int out_w, float padding, float aspect, int vec_ok,
           cudaStream_t stream) {
  const int tiles = (out_h + TH - 1) / TH;
  const int capc = min(CAPC, (W + 7) & ~7);
  // At most 48 KB (out_w up to 1316): a wider crop's launch is refused.
  const size_t smem = (static_cast<size_t>(capc) * 3 + static_cast<size_t>(out_w) * 7) * 4;
  crop_kernel<T><<<B * tiles, NT, smem, stream>>>(
      static_cast<const T*>(frames), static_cast<const float*>(boxes), static_cast<T*>(out),
      static_cast<float*>(scale), static_cast<float*>(offset), H, W, out_h, out_w, padding,
      aspect, tiles, capc, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Crop B contiguous frames (B, H, W, 3) (bf16 when is_bf16, else f32) to
// out (B, out_h, out_w, 3) of the same type, and write scale (B, 2) and
// offset (B, 2) f32, on `stream`.  boxes (B, 4) f32 contiguous.  vec_ok: the
// frames' base is 16-byte aligned and a row (W * 3 elements) is a whole
// number of 16-byte vectors.  Returns the CUDA error code of the launch.
// The wrapper (ops/crop_resample.py) has checked shapes, types and devices.
extern "C" int mc3d_crop_resample(const void* frames, const void* boxes, void* out, void* scale,
                                  void* offset, int B, int H, int W, int out_h, int out_w,
                                  float padding, float aspect, int is_bf16, int vec_ok,
                                  void* stream) {
  if (B == 0 || out_h == 0 || out_w == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(frames, boxes, out, scale, offset, B, H, W, out_h,
                                         out_w, padding, aspect, vec_ok, s)
                 : launch<float>(frames, boxes, out, scale, offset, B, H, W, out_h, out_w,
                                 padding, aspect, vec_ok, s);
}
