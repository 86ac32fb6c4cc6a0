// Swin window attention core on Hopper (sm_90a), bf16 in and out.
//
// Replaces, in the JAX package, ops/pallas/window_attention.py::
// fused_window_attention (one window per grid step) and ::
// packed_window_attention (several windows per matrix-unit pass), and the attention
// step of ops/pallas/swin_block.py::fused_swin_block and, in row mode, of
// ::fused_swin_block_fixed and ::fused_swin_stage_fixed.  For window w and head h
// of qkv (Bw, n, 3C) (q | k | v, C = heads * 32):
//   s   = f32(q_h k_h^T) * 32^-1/2 + bias[h] + mask[w mod nW]
//   p   = bf16(softmax_f32(s))            (row-wise)
//   ctx = bf16(f32(p v_h))                -> out[w, :, h*32 : h*32+32]
// exactly the Pallas kernels' cast points: the scale, the bias and the mask
// are each a rounded f32 operation, in that order (no fused multiply-add).
//
// Row mode (the fixed-order stage layout): qkv and out are (B*P, 3C) and
// (B*P, C), each crop's tokens in shift-0 window order padded to P rows, and
// window w of crop c = w / nW reads and writes token k at row
// c*P + rows[(w % nW)*n + k], rows being the block's (shifted) window
// grouping of the fixed order (window_roll_perm).  The Pallas kernels' full
// (P, P) table (bias, -100 across wrap regions, -1e5 across windows) is
// exactly this per-window attention; its P - nW*n alignment rows per crop
// attend only to themselves, so their ctx is their own v, which extra CTAs,
// one per crop, copy in the same launch.  The TPU kernels' packing of WB
// windows into one block-diagonal product (-1e5 off the diagonal) works
// around the TPU matrix unit's per-pass latency; here each window is its own.
//
// What bounds it.  At the Swin-B stage-0 shapes (256 crops: 17,920 windows
// of n = 49, C = 128, 4 heads; 786,432 of the 878,080 window tokens are
// real, the rest window padding) it must read the real tokens' q (201 MB)
// and every token's k and v (450 MB) and write the real tokens' ctx
// (201 MB), 0.25 ms at 3.35 TB/s, while the products of n keys for each real
// query are 20 GFLOP (0.02 ms at 989 TFLOP/s): bound by bytes at every stage
// (0.25, 0.14, 0.08, 0.05 ms per launch, 2.24 ms for the 24 blocks;
// chip_smoke.py computes them).  Per (window, head) the work is a 9.4 KB
// read of 64-byte row slices, a 3 KB write and about 600 instructions a
// warp (the f32 exp alone is 9 of them per score), so both the memory
// system and the instruction issue have to be kept busy at once.
//
// Design.
// - Work: a CTA of 4 warps owns one head h and one window-in-crop index wi
//   and walks that (h, wi) window through a run of `chunk` consecutive crops
//   (the last run of each (h, wi) may be shorter).  Chained mode is the same
//   walk with a crop of nW*n rows (nW = 1 when there is no mask).  The
//   launcher sizes `chunk` for about 16 CTAs per SM (stage 3: 64 (h, wi)
//   pairs x 32 runs of 8 crops), so the block scheduler balances the tail.
//   Heads vary fastest over blockIdx, so the CTAs resident together read
//   neighbouring 64-byte slices of the same rows.
// - Tables once per CTA: bias[h] and mask[wi] are the same for every window
//   of the run, so each thread loads the entries of its own score fragment
//   (two query rows, 2*NT columns) into registers once; columns >= n carry
//   -inf in the bias register.  The run's n row offsets (chained: wi*n + k;
//   row mode: rows[wi*n + k]) are staged in shared memory once.  Nothing is
//   re-read per window.
// - Pipelined loads: q, k and v of the head (n rows x 64 B each) arrive
//   through a 3-window cp.async ring, 16 B per copy, gathered through the
//   offset table (row mode needs the gather, so no TMA), with L2 fetching
//   whole 128-byte lines for the neighbouring head's CTA; the loads of the
//   next two crops are in flight while a window computes, one
//   __syncthreads per window.  Rows n..63 of the ring are zeroed once.
// - Fragments: Q and K by ldmatrix, V^T by ldmatrix.trans straight from the
//   row-major v tile (no transpose pass); shared rows are padded to 80 B so
//   every ldmatrix is free of bank conflicts.  Warp i owns query rows
//   16i..16i+15; S = Q K^T is 2 k-steps x NT n-tiles of mma.sync m16n8k16
//   (NT = ceil(n/8), a template argument: 7 for the 7x7 window), the f32
//   softmax runs on the accumulators (four lanes per row, two shuffles; the
//   row sum's correctly rounded reciprocal scales the exponentials), and
//   the probabilities, rounded to bf16, are re-packed in registers as the A
//   fragments of P V.  ctx leaves from the registers.
// - Head dim 32 only (Swin-T, -B and -L) and n <= 64; the wrapper raises
//   otherwise.  151 registers for the masked 7x7 kernel: 3 CTAs per SM.
//
// Measured (H100 80GB HBM3, 700 W; PERF.md section 6), on the Swin-B
// main paths' qkv: 4.04 ms per forward chained and 4.10 in row mode (the
// shifted launch x depth), 1.8x the bound, against 15.8 and 16.0 for the
// kernel it replaces (one CTA per window walking the heads in series,
// tables re-staged for every head) and 37 for SDPA.  With the compute
// skipped the loads alone take 2.37 ms; with the loads skipped, about 3.2:
// the two overlap in part.  Measured and not kept: a 2- or 4-window ring
// (within 2%), at most 128 registers (4 CTAs per SM, spills, 3% slower),
// 8 or 32 CTAs per SM (mixed, within 3%), the fast approximate exp (5%
// faster, twice the error at stage 3) and no L2 line hint (3-7% slower).

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 32;              // head dim
constexpr int ROWS = 64;           // tokens per window, padded to 4 m16 tiles
constexpr int LD = D + 8;          // bf16 row stride in shared memory (80 B)
constexpr int TILE = ROWS * LD;    // one of q, k, v of one window, bf16 elements
constexpr int STAGE = 3 * TILE;    // q, k, v of one window
constexpr int STAGES = 3;          // windows in the cp.async ring
constexpr int NTHREADS = 128;
constexpr int CTAS_PER_SM = 16;    // target CTAs per SM when sizing the run
constexpr int MAX_DEVICES = 16;
constexpr size_t SMEM = sizeof(bf16) * STAGES * STAGE + sizeof(int) * ROWS;
static_assert(SMEM <= 48 * 1024, "the launch asks for no more than the default shared memory");

struct Params {
  const bf16* qkv;
  const float* bias;
  const float* mask;  // null: no mask
  const int* rows;    // null: chained mode
  bf16* out;
  int n, heads, C, nW;
  int crops;          // windows per (h, wi): Bw / nW
  int stride;         // rows per crop: P in row mode, nW * n chained
  int chunk;          // crops per CTA
  int runs;           // ceil(crops / chunk)
  int P;              // row mode: rows per crop (alignment rows at nW*n .. P-1)
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, around L1; L2 fetches the whole 128-byte line,
// which the CTAs of the neighbouring head read at about the same time.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Row mode: crop c's alignment rows take their own v as ctx.
__device__ void copy_alignment_rows(const Params& p, int c) {
  const size_t ld = 3 * static_cast<size_t>(p.C);
  const size_t first = static_cast<size_t>(c) * p.P + static_cast<size_t>(p.nW) * p.n;
  const int chunks = p.C / 8, count = (p.P - p.nW * p.n) * chunks;
  for (int i = threadIdx.x; i < count; i += NTHREADS) {
    const size_t r = first + i / chunks;
    const int col = (i % chunks) * 8;
    *reinterpret_cast<uint4*>(p.out + r * p.C + col) =
        *reinterpret_cast<const uint4*>(p.qkv + r * ld + 2 * p.C + col);
  }
}

template <bool MASK, int NT>
__global__ void __launch_bounds__(NTHREADS, 3) window_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  int* sOff = reinterpret_cast<int*>(ring + STAGES * STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = p.n;
  const int pairs = p.heads * p.nW;
  int bid = blockIdx.x;
  if (bid >= pairs * p.runs) {
    copy_alignment_rows(p, bid - pairs * p.runs);
    return;
  }
  // Heads vary fastest, so CTAs resident together read neighbouring columns.
  const int h = bid % p.heads;
  bid /= p.heads;
  const int wi = bid % p.nW;
  const int first = (bid / p.nW) * p.chunk;
  const int count = min(p.chunk, p.crops - first);

  if (tid < n) {
    int r = wi * n + tid;
    if (p.rows != nullptr) {
      r = p.rows[r];
      assert(r >= 0 && r < p.nW * n);  // a bad table stops the kernel, as torch's indexing does
    }
    sOff[tid] = r;
  }
  // Rows n..63 of every ring slot stay zero: k and v padding must be finite.
  const int pad = (ROWS - n) * (D / 8);
  for (int i = tid; i < STAGES * 3 * pad; i += NTHREADS) {
    const int tile = i / pad, j = i % pad;
    *reinterpret_cast<uint4*>(ring + tile * TILE + (n + j / (D / 8)) * LD + (j % (D / 8)) * 8) =
        make_uint4(0, 0, 0, 0);
  }

  // This thread's score entries: rows ra, rb, columns 8j + 2t + {0, 1}.
  const int r0 = warp * 16, ra = r0 + g, rb = ra + 8;
  float tb[NT][4], tm[MASK ? NT : 1][4];
  {
    const float* bh = p.bias + static_cast<size_t>(h) * n * n;
    const float* mw = MASK ? p.mask + static_cast<size_t>(wi) * n * n : nullptr;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb, col = j * 8 + 2 * t + (e & 1);
        const bool in = row < n && col < n;
        tb[j][e] = col >= n ? -INFINITY : (in ? bh[row * n + col] : 0.f);
        if constexpr (MASK) tm[j][e] = in ? mw[row * n + col] : 0.f;
      }
    }
  }
  __syncthreads();  // sOff is in
  const int off_a = ra < n ? sOff[ra] : 0, off_b = rb < n ? sOff[rb] : 0;

  const size_t ld = 3 * static_cast<size_t>(p.C);
  const bf16* src0 = p.qkv + static_cast<size_t>(h) * D + (tid & 3) * 8;
  const uint32_t ring_u32 = smem_u32(ring);
  // q, k, v of crop first + i into ring slot i % STAGES: thread tid copies
  // 16-byte chunk tid & 3 of rows tid/4, tid/4 + 32.
  auto issue = [&](int i) {
    const size_t base = static_cast<size_t>(first + i) * p.stride;
    const uint32_t slot = ring_u32 + (i % STAGES) * (STAGE * 2) + (tid & 3) * 16;
    for (int r = tid >> 2; r < n; r += NTHREADS / 4) {
      const bf16* src = src0 + (base + sOff[r]) * ld;
      const uint32_t dst = slot + r * (LD * 2);
      cp_async16(dst, src);
      cp_async16(dst + TILE * 2, src + p.C);
      cp_async16(dst + 2 * TILE * 2, src + 2 * p.C);
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // window i is in; every warp is done with slot (i - 1) % STAGES
    if (i + STAGES - 1 < count) issue(i + STAGES - 1);
    cp_async_commit();
    if (r0 >= n) continue;  // all 16 rows of this warp are padding

    const uint32_t sq = ring_u32 + (i % STAGES) * (STAGE * 2);
    const uint32_t sk = sq + TILE * 2, sv = sk + TILE * 2;

    // ---- S = Q K^T, 16 rows x 8*NT columns per warp.
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldsm_x4(qa[kk], sq + ((r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8) * 2);
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t kb[4];  // d 0-7, 8-15, 16-23, 24-31 of keys 8j .. 8j+7
      ldsm_x4(kb, sk + ((j * 8 + (lane & 7)) * LD + (lane >> 3) * 8) * 2);
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mma_bf16(s[j], qa[0], kb[0], kb[1]);
      mma_bf16(s[j], qa[1], kb[2], kb[3]);
    }

    // ---- scale, bias, mask (each rounded, in that order); f32 row softmax.
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = __fadd_rn(__fmul_rn(s[j][e], p.scale), tb[j][e]);
        if constexpr (MASK) v = __fadd_rn(v, tm[j][e]);
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
    for (int j = 0; j < NT; ++j) {
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
    const float inv_a = __frcp_rn(sum_a), inv_b = __frcp_rn(sum_b);

    // ---- ctx = P V: P's accumulator layout is the A fragment layout.
    float o[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < (NT + 1) / 2; ++kk) {
      uint32_t a[4];
      a[0] = pack2(s[2 * kk][0] * inv_a, s[2 * kk][1] * inv_a);
      a[1] = pack2(s[2 * kk][2] * inv_b, s[2 * kk][3] * inv_b);
      if (2 * kk + 1 < NT) {
        a[2] = pack2(s[2 * kk + 1][0] * inv_a, s[2 * kk + 1][1] * inv_a);
        a[3] = pack2(s[2 * kk + 1][2] * inv_b, s[2 * kk + 1][3] * inv_b);
      } else {
        a[2] = a[3] = 0u;
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t vb[4];  // keys 16kk + 0-7 / 8-15 of d 16jj + 0-7, then of d 16jj + 8-15
        ldsm_x4_trans(vb, sv + ((kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                jj * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(o[2 * jj], a, vb[0], vb[1]);
        mma_bf16(o[2 * jj + 1], a, vb[2], vb[3]);
      }
    }
    const size_t base = static_cast<size_t>(first + i) * p.stride;
    bf16* out = p.out + static_cast<size_t>(h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ra < n)
        *reinterpret_cast<uint32_t*>(out + (base + off_a) * p.C + j * 8) = pack2(o[j][0], o[j][1]);
      if (rb < n)
        *reinterpret_cast<uint32_t*>(out + (base + off_b) * p.C + j * 8) = pack2(o[j][2], o[j][3]);
    }
  }
}

template <bool MASK>
void launch(int NT, int grid, const Params& p, cudaStream_t s) {
  switch (NT) {
    case 1: window_attention_kernel<MASK, 1><<<grid, NTHREADS, SMEM, s>>>(p); break;
    case 2: window_attention_kernel<MASK, 2><<<grid, NTHREADS, SMEM, s>>>(p); break;
    case 3: window_attention_kernel<MASK, 3><<<grid, NTHREADS, SMEM, s>>>(p); break;
    case 4: window_attention_kernel<MASK, 4><<<grid, NTHREADS, SMEM, s>>>(p); break;
    case 5: window_attention_kernel<MASK, 5><<<grid, NTHREADS, SMEM, s>>>(p); break;
    case 6: window_attention_kernel<MASK, 6><<<grid, NTHREADS, SMEM, s>>>(p); break;
    case 7: window_attention_kernel<MASK, 7><<<grid, NTHREADS, SMEM, s>>>(p); break;
    default: window_attention_kernel<MASK, 8><<<grid, NTHREADS, SMEM, s>>>(p); break;
  }
}

}  // namespace

// Launch the window attention of Bw windows on `stream`: qkv (Bw, n, 3C) and
// out (Bw, n, C) bf16, bias (heads, n, n) f32, mask (nW, n, n) f32 or null
// (window w takes mask w mod nW; nW = 1 without a mask).  With a row table
// `rows` (nW*n int32, the row of each shifted-window position inside its
// crop), qkv and out are (Bw/nW*P, 3C) and (Bw/nW*P, C) instead, nW is the
// windows per crop and P the rows per crop (P >= nW*n).  The wrapper
// (ops/window_attention.py) has checked n <= 64, C == 32 * heads, the table,
// types and contiguity.  Returns the CUDA error code of the launch.
extern "C" int mc3d_window_attention(const void* qkv, const void* bias,
                                     const void* mask, const void* rows, void* out,
                                     int Bw, int n, int heads, int C, int nW, int P,
                                     void* stream) {
  if (n <= 0 || n > ROWS || C != heads * D || Bw <= 0 || nW <= 0 || Bw % nW != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows != nullptr && P < nW * n) return static_cast<int>(cudaErrorInvalidValue);

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

  Params p;
  p.qkv = static_cast<const bf16*>(qkv);
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.rows = static_cast<const int*>(rows);
  p.out = static_cast<bf16*>(out);
  p.n = n;
  p.heads = heads;
  p.C = C;
  p.nW = nW;
  p.crops = Bw / nW;
  p.stride = rows != nullptr ? P : nW * n;
  p.P = P;
  // d^-1/2 rounded once to f32, as the plain version's Python float is.
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  // About CTAS_PER_SM CTAs per SM, each a run of 1 .. crops windows.
  const long long units = static_cast<long long>(heads) * Bw;
  const long long target = static_cast<long long>(sms) * CTAS_PER_SM;
  long long chunk = (units + target - 1) / target;
  if (chunk > p.crops) chunk = p.crops;
  p.chunk = static_cast<int>(chunk);
  p.runs = (p.crops + p.chunk - 1) / p.chunk;
  const long long ctas = static_cast<long long>(heads) * nW * p.runs;
  // Row mode with alignment rows: one more CTA per crop copies their v.
  const long long grid = ctas + (rows != nullptr && P > nW * n ? p.crops : 0);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int NT = (n + 7) / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask != nullptr)
    launch<true>(NT, static_cast<int>(grid), p, s);
  else
    launch<false>(NT, static_cast<int>(grid), p, s);
  return static_cast<int>(cudaGetLastError());
}
