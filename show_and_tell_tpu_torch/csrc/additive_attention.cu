// Additive (Bahdanau) attention over an image's patch grid, one row per
// image (K = 1), on Hopper (sm_90a).
//
// Replaces: show_and_tell_tpu/ops/fused_attention.py `_attn_kernel` (greedy
// decoding, and the forward of training's attention), and, by the one-pass
// kernel with K rows of hp per image,
// show_and_tell_tpu/ops/fused_decode_attention.py `_kernel_grid2` (the
// (image, beam) grid, `variant="grid2"`). The beam-shared form (K beams per
// image in one block row) is csrc/decode_attention.cu's; the first kernel
// below is written for any K, and only its K = 1 instance is built.
//
// For image b and beam k:
//     e[k, l]   = sum_d tanh(ce[b, l, d] + hp[b, k, d]) * w_att[d]   (fp32)
//     alpha[k]  = softmax_l(e[k])                                    (fp32)
//     ctx[k, d] = sum_l alpha[k, l] * f[b, l, d] / L
// ce, f: [B, L, D]; hp: [B, K, D]; w_att: [D]; all fp32 or all bf16.
// Outputs ctx [B, K, D] in that type and alpha [B, K, L] in fp32. As in the
// reference, alpha is rounded to the compute type before the context sum.
//
// Bound on an H100 at the serving shape (B=256, L=196, D=512, bf16): ce and f
// are 102.8 MB, read once at 3.35 TB/s in 30.7 us, larger than the 50 MB L2,
// so they arrive cold. The arithmetic is 77.1 M tanh for K=3 (25.7 M for
// K=1); the precise tanhf costs tens of instructions, so the kernel sits near
// the line between the two bounds.
//
// Two designs, chosen by ops/fused_attention.py `attention_plan`:
//
// `onepass` (sat_additive_attention_onepass), for rows that are 16-byte
// multiples of at most 32 elements per lane and 16-byte aligned operands
// (the serving and training shapes). What held the first design back was
// bytes in flight and three phases with block barriers between them, so:
//   - (the (image, beam) grid) with K rows of hp per image, block row b
//     reads image b / K, the beam innermost as the TPU grid runs it: the K
//     blocks of an image run together, so the second and third reads of its
//     ce and f come from the 50 MB L2 (K=3 at the serving shape takes about
//     1.4 times the per-row attention's time on the H100, PERF.md). The K = 1
//     instance is the per-row attention's kernel as it was, the image index
//     a template choice;
//   - an image is split over C blocks (a cluster; C from the plan), each
//     with a contiguous share of the patch rows, and a warp takes every
//     NW-th row of the share;
//   - there is one pass: a warp keeps its next four rows of ce and of f on
//     their way into a ring in shared memory (`cp.async`, 16 bytes per lane
//     per vector: 8 KB per warp in flight in bf16, whatever the registers
//     hold), takes the oldest, forms the score, and folds the f row into a
//     running context under a running max m and sum s of exp (rescaled when
//     m rises). f is asked for with ce, not after a softmax, and no barrier
//     stands between a warp and its next row;
//   - hp and w_att stay in registers: with K = 1 a lane needs only its own
//     16 elements of each, for every row;
//   - the tanh is `tanh.approx.bf16x2` on `add.bf16x2` in bf16, rounded
//     where the plain version rounds them, and `ex2.approx` + `rcp.approx`
//     in fp32 (sat_common.cuh);
//   - the warps' (m, s, context) meet once in shared memory, the blocks'
//     once through distributed shared memory (one cluster barrier, and one
//     before exit); alpha = exp(e - m) / s is written from the scores the
//     block kept. alpha reaches the context in fp32, not rounded to the
//     compute type first as the plain version does: inside the tolerances
//     (fp32 2e-5 and 1e-5 of scale, bf16 2e-2), and held there on the card.
//
// `direct` (sat_additive_attention), the first design, for every other
// shape: one block per image. Every ce and f element is read from device
// memory exactly once, whatever K: a warp takes one patch row l, loads
// ce[b, l, :] (in 16-byte vectors where D and the pointers allow it) and
// forms the K scores from it, with hp and w_att held in shared memory as
// fp32. The softmax runs per beam over L in shared memory, and then the
// threads stream f[b, :, d] once and accumulate all K contexts. No [B, L, D]
// or [B, K, L, D] intermediate exists and L needs no padding: L = 196 and
// L = 13 are loop bounds. Its tanhf is the precise one.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "sat_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;   // threads per block (8 warps)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// VEC: elements per 16-byte load of ce (1 = scalar loads).
template <typename T, int K, int VEC>
__global__ void __launch_bounds__(NT)
additive_attention_kernel(const T* __restrict__ ce, const T* __restrict__ f,
                          const T* __restrict__ hp, const T* __restrict__ watt,
                          T* __restrict__ ctx, float* __restrict__ alpha, int L, int D) {
  extern __shared__ __align__(16) float sm[];
  float* s_hp = sm;           // [K][D]
  float* s_w = s_hp + K * D;  // [D]
  float* s_e = s_w + D;       // [K][L]: scores, then alpha in the compute type

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = NT / 32;
  const T* ce_b = ce + (size_t)b * L * D;
  const T* f_b = f + (size_t)b * L * D;

  for (int i = tid; i < K * D; i += NT) s_hp[i] = to_f(hp[(size_t)b * K * D + i]);
  for (int i = tid; i < D; i += NT) s_w[i] = to_f(watt[i]);
  __syncthreads();

  // 1. scores: a warp per patch row, the row read once for all K beams
  for (int l = warp; l < L; l += NW) {
    const T* row = ce_b + (size_t)l * D;
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    if constexpr (VEC > 1) {
      for (int d0 = lane * VEC; d0 < D; d0 += 32 * VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int q = 0; q < VEC; q += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(s_w + d0 + q);
          const float c0 = to_f(v[q]), c1 = to_f(v[q + 1]);
          const float c2 = to_f(v[q + 2]), c3 = to_f(v[q + 3]);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float4 h4 = *reinterpret_cast<const float4*>(s_hp + k * D + d0 + q);
            acc[k] += tanhf(c0 + h4.x) * w4.x + tanhf(c1 + h4.y) * w4.y +
                      tanhf(c2 + h4.z) * w4.z + tanhf(c3 + h4.w) * w4.w;
          }
        }
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        const float cv = to_f(row[d]);
        const float wv = s_w[d];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] += tanhf(cv + s_hp[k * D + d]) * wv;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float e = warp_sum(acc[k]);
      if (lane == 0) s_e[k * L + l] = e;
    }
  }
  __syncthreads();

  // 2. fp32 softmax over L, a warp per beam
  for (int k = warp; k < K; k += NW) {
    float* e = s_e + k * L;
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, e[l]);
    m = warp_max(m);
    float s = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float p = expf(e[l] - m);
      e[l] = p;
      s += p;
    }
    s = warp_sum(s);
    float* a_out = alpha + ((size_t)b * K + k) * L;
    for (int l = lane; l < L; l += 32) {
      const float a = e[l] / s;
      a_out[l] = a;
      e[l] = to_f(from_f<T>(a));
    }
  }
  __syncthreads();

  // 3. context: each f element read once, all K sums accumulated in fp32
  const float fl = (float)L;
  for (int d = tid; d < D; d += NT) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    for (int l = 0; l < L; ++l) {
      const float fv = to_f(f_b[(size_t)l * D + d]);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = fmaf(s_e[k * L + l], fv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) ctx[((size_t)b * K + k) * D + d] = from_f<T>(acc[k] / fl);
  }
}

template <typename T, int K, int VEC>
cudaError_t launch_k(const void* ce, const void* f, const void* hp, const void* watt, void* ctx,
                     float* alpha, int B, int L, int D, cudaStream_t s) {
  const size_t smem = (size_t)(K * D + D + K * L) * sizeof(float);
  auto kern = additive_attention_kernel<T, K, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<B, NT, smem, s>>>(static_cast<const T*>(ce), static_cast<const T*>(f),
                           static_cast<const T*>(hp), static_cast<const T*>(watt),
                           static_cast<T*>(ctx), alpha, L, D);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch(const void* ce, const void* f, const void* hp, const void* watt, void* ctx,
                   float* alpha, int B, int K, int L, int D, cudaStream_t s) {
  if (K != 1) return cudaErrorInvalidValue;
  return launch_k<T, 1, VEC>(ce, f, hp, watt, ctx, alpha, B, L, D, s);
}


// --- the one-pass design ------------------------------------------------------

constexpr int ONEPASS_NT_MAX = 256;  // threads per block, at most
constexpr int ONEPASS_CMAX = 8;      // blocks per image, at most (the portable cluster limit)
constexpr int P = 4;                 // rows of ce and of f per warp in flight (a power of two)

// Dynamic shared memory of one block, in floats; must agree with the
// kernel's layout (and with `onepass_smem_bytes` in ops/fused_attention.py).
// The ring comes first: NW warps x P stages x (ce, f) x NV vectors x 32 lanes.
__host__ __device__ __forceinline__ size_t onepass_smem_floats(int NW, int NV, int Lc, int D) {
  return (size_t)NW * P * 2 * NV * 32 * 4 + (size_t)NW * D + D + 4 + 2 * 32 + Lc;
}

// NV: 16-byte vectors per lane that cover a row (D <= NV * 32 * VEC). BEAMS:
// K rows of hp per image, the (image, beam) grid, where row b of hp, ctx and
// alpha reads image b / K; without it every row is its own image (K = 1).
template <typename T, int NV, bool BEAMS>
__global__ void __launch_bounds__(ONEPASS_NT_MAX)
attention_onepass_kernel(const T* __restrict__ ce, const T* __restrict__ f,
                         const T* __restrict__ hp, const T* __restrict__ watt,
                         T* __restrict__ ctx, float* __restrict__ alpha, int K, int L, int D) {
  constexpr int VEC = 16 / sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / C;  // the row of hp, ctx and alpha
  const int img = BEAMS ? b / K : b;
  const int Lc = (L + C - 1) / C;
  const int l0 = r * Lc;
  const int nl = max(0, min(L, l0 + Lc) - l0);  // rows of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;

  extern __shared__ __align__(16) float sm1[];
  uint4* ring = reinterpret_cast<uint4*>(sm1);  // [nw][P][ce, f][NV][32]
  float* s_acc = sm1 + (size_t)nw * P * 2 * NV * 32 * 4;  // [nw][D] the warps' contexts
  float* s_part = s_acc + nw * D;     // [D] the block's context, read by the cluster
  float* s_stat = s_part + D;         // the block's m and s, read by the cluster
  float* s_wm = s_stat + 4;           // [32] the warps' m
  float* s_ws = s_wm + 32;            // [32] the warps' s, then their weights
  float* s_e = s_ws + 32;             // [Lc] the block's scores

  // this warp's first P rows of ce and f on their way
  const T* ce_b = ce + ((size_t)img * L + l0) * D;
  const T* f_b = f + ((size_t)img * L + l0) * D;
  uint4* my = ring + (size_t)warp * P * 2 * NV * 32 + lane;  // stage p: my + p * 2 * NV * 32
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int lr = warp + p * nw;
    if (lr < nl) {
      sat::copy_row<T, NV>(my + p * 2 * NV * 32, ce_b + (size_t)lr * D, lane, D);
      sat::copy_row<T, NV>(my + (p * 2 + 1) * NV * 32, f_b + (size_t)lr * D, lane, D);
    }
    sat::cp_async_commit();
  }

  // this lane's elements of hp[b] and w_att, for every row
  uint4 hv[NV];
  float wv[NV][VEC];
  {
    uint4 wraw[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      hv[i] = make_uint4(0, 0, 0, 0);
      wraw[i] = make_uint4(0, 0, 0, 0);
    }
    sat::load_row<T, NV>(hv, hp + (size_t)b * D, lane, D);
    sat::load_row<T, NV>(wraw, watt, lane, D);
#pragma unroll
    for (int i = 0; i < NV; ++i) sat::unpack<T>(wraw[i], wv[i]);
  }

  // one pass over this warp's rows: the score, then the row of f folded
  // into the running context under the running max and sum of exp
  float m = -INFINITY, s = 0.f;
  float acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[i][q] = 0.f;
  int p = 0;
  for (int lr = warp; lr < nl; lr += nw) {
    sat::cp_async_wait<P - 1>();  // the oldest stage has landed
    uint4* stage = my + p * 2 * NV * 32;
    uint4 cv[NV], fr[NV];
    sat::read_row<NV>(cv, stage);
    sat::read_row<NV>(fr, stage + NV * 32);
    float e = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if ((i * 32 + lane) * VEC < D) e += sat::score_vec<T>(cv[i], hv[i], wv[i]);
    e = sat::warp_sum(e);
    if (lane == 0) s_e[lr] = e;
    if (e > m) {  // the same for every lane of the warp
      const float scale = expf(m - e);  // 0 at the first row
      s *= scale;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[i][q] *= scale;
      m = e;
    }
    const float pw = expf(e - m);
    s += pw;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((i * 32 + lane) * VEC < D) {
        float fv[VEC];
        sat::unpack<T>(fr[i], fv);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[i][q] = fmaf(pw, fv[q], acc[i][q]);
      }
    }
    // the stage is in registers and used: refill it with the row P ahead
    const int nxt = lr + P * nw;
    if (nxt < nl) {
      sat::copy_row<T, NV>(stage, ce_b + (size_t)nxt * D, lane, D);
      sat::copy_row<T, NV>(stage + NV * 32, f_b + (size_t)nxt * D, lane, D);
    }
    sat::cp_async_commit();
    p = (p + 1) & (P - 1);
  }

  // the warps meet: m = max, and each warp's s and context weighted by
  // exp(m_w - m)
  if (lane == 0) {
    s_wm[warp] = m;
    s_ws[warp] = s;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d0 = (i * 32 + lane) * VEC;
    if (d0 < D) {
#pragma unroll
      for (int q = 0; q < VEC; q += 4)
        *reinterpret_cast<float4*>(s_acc + warp * D + d0 + q) =
            make_float4(acc[i][q], acc[i][q + 1], acc[i][q + 2], acc[i][q + 3]);
    }
  }
  __syncthreads();
  if (warp == 0) {
    const float mw = lane < nw ? s_wm[lane] : -INFINITY;
    const float sw = lane < nw ? s_ws[lane] : 0.f;
    const float mb = sat::warp_max(mw);
    const float wgt = sw > 0.f ? expf(mw - mb) : 0.f;
    const float sb = sat::warp_sum(sw * wgt);
    if (lane < nw) s_ws[lane] = wgt;
    if (lane == 0) {
      s_stat[0] = mb;
      s_stat[1] = sb;
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += nt) {
    float v = 0.f;
    for (int w = 0; w < nw; ++w) v = fmaf(s_ws[w], s_acc[w * D + d], v);
    s_part[d] = v;
  }

  // the blocks of the image meet through distributed shared memory
  cluster.sync();
  float mq = -INFINITY, sq = 0.f;
  if (lane < C) {
    const float* st = cluster.map_shared_rank(s_stat, lane);
    mq = st[0];
    sq = st[1];
  }
  const float mg = sat::warp_max(mq);
  const float wq = sq > 0.f ? expf(mq - mg) : 0.f;
  const float sg = sat::warp_sum(sq * wq);
  float wgts[ONEPASS_CMAX];
#pragma unroll
  for (int q = 0; q < ONEPASS_CMAX; ++q) wgts[q] = __shfl_sync(0xffffffffu, wq, q);
  const float inv = 1.f / sg;

  float* a_out = alpha + (size_t)b * L + l0;
  for (int l = tid; l < nl; l += nt) a_out[l] = expf(s_e[l] - mg) * inv;

  // block r sums the C contexts of its slice of D
  const int Dc = (D + C - 1) / C;
  const int dlo = r * Dc, nd = max(0, min(D, dlo + Dc) - dlo);
  const float norm = inv / (float)L;
  for (int i = tid; i < nd; i += nt) {
    const int d = dlo + i;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < ONEPASS_CMAX; ++q)
      if (q < C) v = fmaf(wgts[q], cluster.map_shared_rank(s_part, q)[d], v);
    ctx[(size_t)b * D + d] = sat::from_f<T>(v * norm);
  }
  cluster.sync();  // no block leaves while another still reads its context
}

template <typename T, int NV, bool BEAMS>
cudaError_t launch_onepass_nv(const void* ce, const void* f, const void* hp, const void* watt,
                              void* ctx, float* alpha, int B, int K, int L, int D, int C, int nt,
                              cudaStream_t s) {
  const int Lc = (L + C - 1) / C;
  const size_t smem = onepass_smem_floats(nt / 32, NV, Lc, D) * sizeof(float);
  auto kern = attention_onepass_kernel<T, NV, BEAMS>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * K * C);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(ce), static_cast<const T*>(f),
                         static_cast<const T*>(hp), static_cast<const T*>(watt),
                         static_cast<T*>(ctx), alpha, K, L, D);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, bool BEAMS>
cudaError_t launch_onepass_k(const void* ce, const void* f, const void* hp, const void* watt,
                             void* ctx, float* alpha, int B, int K, int L, int D, int C, int nt,
                             cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (D % VEC || D > 4 * 32 * VEC) return cudaErrorInvalidValue;
  if (D <= 32 * VEC)
    return launch_onepass_nv<T, 1, BEAMS>(ce, f, hp, watt, ctx, alpha, B, K, L, D, C, nt, s);
  if (D <= 2 * 32 * VEC)
    return launch_onepass_nv<T, 2, BEAMS>(ce, f, hp, watt, ctx, alpha, B, K, L, D, C, nt, s);
  return launch_onepass_nv<T, 4, BEAMS>(ce, f, hp, watt, ctx, alpha, B, K, L, D, C, nt, s);
}

template <typename T>
cudaError_t launch_onepass(const void* ce, const void* f, const void* hp, const void* watt,
                           void* ctx, float* alpha, int B, int K, int L, int D, int C, int nt,
                           cudaStream_t s) {
  if (K == 1) return launch_onepass_k<T, false>(ce, f, hp, watt, ctx, alpha, B, K, L, D, C, nt, s);
  return launch_onepass_k<T, true>(ce, f, hp, watt, ctx, alpha, B, K, L, D, C, nt, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: 1 when D is a multiple of the
// 16-byte vector width and ce is 16-byte aligned. Returns a cudaError_t.
extern "C" int sat_additive_attention(const void* ce, const void* f, const void* hp,
                                      const void* watt, void* ctx, float* alpha, int B, int K,
                                      int L, int D, int dtype, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || D <= 0 || K != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return (int)(vec ? launch<float, 4>(ce, f, hp, watt, ctx, alpha, B, K, L, D, s)
                     : launch<float, 1>(ce, f, hp, watt, ctx, alpha, B, K, L, D, s));
  }
  if (dtype == 1) {
    return (int)(vec ? launch<__nv_bfloat16, 8>(ce, f, hp, watt, ctx, alpha, B, K, L, D, s)
                     : launch<__nv_bfloat16, 1>(ce, f, hp, watt, ctx, alpha, B, K, L, D, s));
  }
  return (int)cudaErrorInvalidValue;
}

// The one-pass design: ce, f [B, L, D], hp [B, K, D], w_att [D] -> ctx
// [B, K, D], alpha [B, K, L] fp32, `cluster` blocks per row of hp (K = 1: the
// per-row attention; K > 1: the (image, beam) grid, row b * K + k innermost).
// dtype: 0 = float32, 1 = bfloat16. cluster: 1..8. threads: per
// block, a multiple of 32 up to 256. Needs D a multiple of the 16-byte vector
// width, at most 128 vectors per row, and ce, f, hp and w_att 16-byte
// aligned. Returns a cudaError_t.
extern "C" int sat_additive_attention_onepass(const void* ce, const void* f, const void* hp,
                                              const void* watt, void* ctx, float* alpha, int B,
                                              int K, int L, int D, int dtype, int cluster,
                                              int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K < 1 || L <= 0 || D <= 0 || cluster < 1 || cluster > ONEPASS_CMAX ||
      threads < 32 || threads > ONEPASS_NT_MAX || threads % 32 ||
      (long long)B * K * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_onepass<float>(ce, f, hp, watt, ctx, alpha, B, K, L, D, cluster, threads, s);
  if (dtype == 1)
    return (int)launch_onepass<__nv_bfloat16>(ce, f, hp, watt, ctx, alpha, B, K, L, D, cluster, threads, s);
  return (int)cudaErrorInvalidValue;
}
