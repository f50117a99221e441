// The three other forms of the beam-shared decode attention, on Hopper
// (sm_90a). Each replaces one TPU kernel of
// show_and_tell_tpu/ops/fused_decode_attention.py:
//   - attention_scores_stream_kernel, and attention_scores_kernel for the
//     shapes it does not take: `_score_kernel` (scores only, the first half
//     of `attention_beam_hybrid`);
//   - attention_st_cluster_kernel, and attention_st_kernel for the shapes it
//     does not take: `_kernel_st` (ce transposed to [B, D, L]);
//   - attention_grid2_kernel: `_kernel_grid2` (an (image, beam) grid), for
//     the shapes the one-pass kernel of additive_attention.cu, which runs
//     the grid otherwise, does not take.
//
// They compute the function of additive_attention.cu: for image b and beam k,
//     e[k, l]   = sum_d tanh(ce[b, l, d] + hp[b, k, d]) * w_att[d]   (fp32)
//     alpha[k]  = softmax_l(e[k]);  ctx[k, d] = sum_l alpha[k, l] f[b, l, d] / L
// with every product and sum in fp32. The TPU kernels' bf16 products and
// sums (the `s16` and `st` score forms) are not reproduced: on Hopper the
// score forms are one function. The streaming scores kernel and the cluster
// kernel of the transposed form form ce + hp and its tanh in the input type,
// as `_score_kernel` does.
//
// Bounds on an H100 at the serving shape (B=256, K=3, L=196, D=512, bf16):
// 51.4 MB of ce (scores only) or 102.8 MB of ce and f read once at 3.35 TB/s
// (15.3 us and 30.7 us), against the 77.1 M tanh of the scores, one
// special-function operation each (`tanh.approx.bf16x2` runs as two per pair)
// at 16 per clock per SM: 18.4 us. The scores alone are bound by their tanh,
// the full forms by their bytes.
//
// Design:
//   - scores only, `stream` (ops/fused_decode_attention.py `scores_plan`; rows
//     of 16-byte multiples, aligned operands): a patch row's scores depend on
//     no other row, so the grid is (image, slice of L) with no barrier after
//     the operands are in place. A warp takes every NW-th row of its slice,
//     keeps its next eight rows on their way into a ring in shared memory
//     (`cp.async`, 16 bytes per lane per vector: 8 KB per warp in flight),
//     and forms the K scores from the oldest; w_att stays in registers, and hp too where
//     it fits (K vectors per lane: K = 3 at D = 512), else in shared memory
//     as it is. bf16 forms ce + hp and its tanh two at a time in bf16
//     (`tanh.approx.bf16x2`), fp32 uses `ex2.approx` + `rcp.approx`
//     (sat_common.cuh). f is never read. The tanh set the pace: one
//     special-function operation each (the bf16x2 form runs as two), 18.4
//     us of them at the serving shape at 16 per clock per SM, over the 15.3
//     us of bytes; so the blocks are short and many, which keeps more warps
//     on an SM and its special-function units busier.
//   - scores only, `direct`: one block per image; the score phase of the
//     fused kernel (a warp per patch row, ce[b] read once for all K beams,
//     hp and w_att in shared memory as fp32, the precise tanhf), with the
//     scores written straight to e.
//   - transposed, `cluster` (`st_plan`; ce^T rows of 8-byte multiples, f
//     rows of 16-byte multiples, aligned operands): what the TPU layout was
//     for stays, threads along l, so the score over d needs no warp
//     reduction. What held the first kernel back was one block per image, a
//     2-byte load per thread per d, three phases behind block barriers with
//     f asked for only after the softmax, and the precise tanhf. So:
//       * an image is split over a cluster of C blocks (5 at L=196 in bf16),
//         each a slice of l; in a block the warps split D, and a lane takes
//         an 8-byte vector of adjacent l (4 bf16: a ce^T row of L=196 is 392
//         bytes, a multiple of 8 and not of 16, so ce^T needs no padding),
//         32 / Vc rows of ce^T per instruction, so that 30 of 32 lanes are
//         busy at L=196;
//       * ce^T streams through a `cp.async` ring per warp, and one
//         `add.bf16x2` + `tanh.approx.bf16x2` covers two patches against a
//         broadcast hp[k, d] (fp32: `ex2.approx` + `rcp.approx`);
//       * hp[b] and w_att arrive by one bulk copy, and the block's rows of f
//         by another, both started first: f is in flight through the
//         scores;
//       * the warps' partial scores meet once in shared memory (over the
//         ring), each block forms its slice's max m and sum s of exp and its
//         partial context from its f rows, and the blocks meet once through
//         distributed shared memory, each share weighed by exp(m_q - m) / s
//         as in the one-pass kernel's merge; alpha reaches the context in
//         fp32, not rounded to the input type first, inside the tolerances.
//     Measured on the H100, what sets its pace is this skeleton (scores, a
//     block softmax, the context, the cluster merge, each behind a barrier),
//     not the tanh: K=1 takes within 20 % of K=3's time (PERF.md).
//   - transposed, `direct`, the first design: one block per image; threads
//     run along l, so each row ce^T[b, d, :] is a coalesced read, and each
//     thread loops over d with its K scores in registers. Softmax and
//     context are the fused kernel's.
//   - (image, beam) grid, `direct`, the first design: one block per (image,
//     beam) pair, the beam innermost (blockIdx.x = b * K + k), as the TPU
//     grid runs k innermost. The shapes of 16-byte rows run on the one-pass
//     kernel of additive_attention.cu instead.
//
// The phases below are those of additive_attention.cu's first kernel,
// written as device functions that the `direct` kernels here share. That
// kernel keeps its own copy: moved onto these functions it compiled to other
// code (K=3 about 11 % faster, K=1 about 8 % slower on the H100), and the
// serving path it runs is left as it was.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "sat_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;   // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int KMAX = 8;   // largest K (beam width) instantiated

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

// hp [K][D] and w_att [D] into shared memory as fp32.
template <typename T, int K>
__device__ __forceinline__ void load_hp_w(const T* __restrict__ hp, const T* __restrict__ watt,
                                          float* s_hp, float* s_w, int D) {
  for (int i = threadIdx.x; i < K * D; i += NT) s_hp[i] = to_f(hp[i]);
  for (int i = threadIdx.x; i < D; i += NT) s_w[i] = to_f(watt[i]);
}

// The phases, each called by all NT threads of a block, with pointers already
// offset to the image (and row) the block works on; the caller places the
// __syncthreads() between them.

// Scores e[k * L + l] from ce [L][D]: a warp per patch row, the row read once
// for all K rows of hp. VEC: elements per 16-byte load of ce (1 = scalar).
// ``e`` is shared memory in the grid2 kernel and device memory in the
// scores-only kernel.
template <typename T, int K, int VEC>
__device__ __forceinline__ void score_rows(const T* __restrict__ ce, const float* s_hp,
                                           const float* s_w, float* e, int L, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = warp; l < L; l += NW) {
    const T* row = ce + (size_t)l * D;
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
      const float v = warp_sum(acc[k]);
      if (lane == 0) e[k * L + l] = v;
    }
  }
}

// fp32 softmax over L of each row of s_e [K][L], a warp per row. Writes alpha
// [K][L] to device memory and leaves in s_e alpha rounded to T, which the
// context sum reads (the reference rounds alpha to the compute type too).
template <typename T, int K>
__device__ __forceinline__ void softmax_rows(float* s_e, float* __restrict__ alpha, int L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
    float* a_out = alpha + (size_t)k * L;
    for (int l = lane; l < L; l += 32) {
      const float a = e[l] / s;
      a_out[l] = a;
      e[l] = to_f(from_f<T>(a));
    }
  }
}

// ctx [K][D] = alpha [K][L] (in s_a) times f [L][D], over L: each f element
// read once, all K sums accumulated in fp32.
template <typename T, int K>
__device__ __forceinline__ void context_cols(const T* __restrict__ f, const float* s_a,
                                             T* __restrict__ ctx, int L, int D) {
  const float fl = (float)L;
  for (int d = threadIdx.x; d < D; d += NT) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    for (int l = 0; l < L; ++l) {
      const float fv = to_f(f[(size_t)l * D + d]);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = fmaf(s_a[k * L + l], fv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) ctx[(size_t)k * D + d] = from_f<T>(acc[k] / fl);
  }
}

// Raise a kernel's dynamic shared memory limit where it needs more than the
// default 48 KB.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int K, int VEC>
__global__ void __launch_bounds__(NT)
attention_scores_kernel(const T* __restrict__ ce, const T* __restrict__ hp,
                        const T* __restrict__ watt, float* __restrict__ e, int L, int D) {
  extern __shared__ __align__(16) float sm[];
  float* s_hp = sm;           // [K][D]
  float* s_w = s_hp + K * D;  // [D]
  const int b = blockIdx.x;
  load_hp_w<T, K>(hp + (size_t)b * K * D, watt, s_hp, s_w, D);
  __syncthreads();
  score_rows<T, K, VEC>(ce + (size_t)b * L * D, s_hp, s_w, e + (size_t)b * K * L, L, D);
}

template <typename T, int K>
__global__ void __launch_bounds__(NT)
attention_st_kernel(const T* __restrict__ cet, const T* __restrict__ f,
                    const T* __restrict__ hp, const T* __restrict__ watt,
                    T* __restrict__ ctx, float* __restrict__ alpha, int L, int D) {
  extern __shared__ __align__(16) float sm[];
  float* s_hp = sm;           // [K][D]
  float* s_w = s_hp + K * D;  // [D]
  float* s_e = s_w + D;       // [K][L]
  const int b = blockIdx.x;
  const size_t img = (size_t)b * L * D;
  load_hp_w<T, K>(hp + (size_t)b * K * D, watt, s_hp, s_w, D);
  __syncthreads();

  // scores: a thread per patch l, summing over d in registers
  const T* ct = cet + img;  // [D][L]
  for (int l = threadIdx.x; l < L; l += NT) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float cv = to_f(ct[(size_t)d * L + l]);
      const float wv = s_w[d];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] += tanhf(cv + s_hp[k * D + d]) * wv;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) s_e[k * L + l] = acc[k];
  }
  __syncthreads();
  softmax_rows<T, K>(s_e, alpha + (size_t)b * K * L, L);
  __syncthreads();
  context_cols<T, K>(f + img, s_e, ctx + (size_t)b * K * D, L, D);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
attention_grid2_kernel(const T* __restrict__ ce, const T* __restrict__ f,
                       const T* __restrict__ hp, const T* __restrict__ watt,
                       T* __restrict__ ctx, float* __restrict__ alpha, int K, int L, int D) {
  extern __shared__ __align__(16) float sm[];
  float* s_hp = sm;       // [D]
  float* s_w = sm + D;    // [D]
  float* s_e = s_w + D;   // [L]
  const int row = blockIdx.x;  // b * K + k: rows of hp, ctx and alpha
  const size_t img = (size_t)(row / K) * L * D;
  load_hp_w<T, 1>(hp + (size_t)row * D, watt, s_hp, s_w, D);
  __syncthreads();
  score_rows<T, 1, VEC>(ce + img, s_hp, s_w, s_e, L, D);
  __syncthreads();
  softmax_rows<T, 1>(s_e, alpha + (size_t)row * L, L);
  __syncthreads();
  context_cols<T, 1>(f + img, s_e, ctx + (size_t)row * D, L, D);
}

template <typename T, int K, int VEC>
cudaError_t launch_scores_k(const void* ce, const void* hp, const void* watt, float* e, int B,
                            int L, int D, cudaStream_t s) {
  const size_t smem = (size_t)(K * D + D) * sizeof(float);
  auto kern = attention_scores_kernel<T, K, VEC>;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<B, NT, smem, s>>>(static_cast<const T*>(ce), static_cast<const T*>(hp),
                           static_cast<const T*>(watt), e, L, D);
  return cudaGetLastError();
}

// --- scores only, the streaming design ---------------------------------------

// Rows per warp in flight (a power of two): 8 rows of up to 1 KB, 4 of 2 KB.
__host__ __device__ constexpr int stream_stages(int NV) { return NV == 4 ? 4 : 8; }

// NV: 16-byte vectors per lane that cover a row (D <= NV * 32 * VEC). hp
// stays in registers where K * NV vectors per lane are at most 8.
template <typename T, int K, int NV>
__global__ void __launch_bounds__(NT)
attention_scores_stream_kernel(const T* __restrict__ ce, const T* __restrict__ hp,
                               const T* __restrict__ watt, float* __restrict__ e, int S, int L,
                               int D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int P = stream_stages(NV);
  constexpr bool HP_REGS = K * NV <= 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  extern __shared__ __align__(16) unsigned char sm_raw[];
  uint4* ring = reinterpret_cast<uint4*>(sm_raw);  // [nw][P][NV][32]
  uint4* s_hp = ring + (size_t)nw * P * NV * 32;   // [K][D / VEC] (not HP_REGS)

  const int b = blockIdx.x / S, r = blockIdx.x % S;
  const int Lc = (L + S - 1) / S;
  const int l0 = r * Lc;
  const int nl = max(0, min(L, l0 + Lc) - l0);  // rows of this block
  const int nvec = D / VEC;
  const T* ce_b = ce + ((size_t)b * L + l0) * D;
  const T* hp_b = hp + (size_t)b * K * D;

  // this warp's first P rows on their way into its ring, while hp and
  // w_att arrive
  uint4* my = ring + (size_t)warp * P * NV * 32 + lane;  // stage p: my + p * NV * 32
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int lr = warp + p * nw;
    if (lr < nl) sat::copy_row<T, NV>(my + p * NV * 32, ce_b + (size_t)lr * D, lane, D);
    sat::cp_async_commit();
  }

  float wv[NV][VEC];
  uint4 hv[HP_REGS ? K : 1][NV];
  {
    uint4 wraw[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) wraw[i] = make_uint4(0, 0, 0, 0);
    sat::load_row<T, NV>(wraw, watt, lane, D);
#pragma unroll
    for (int i = 0; i < NV; ++i) sat::unpack<T>(wraw[i], wv[i]);
  }
  if constexpr (HP_REGS) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < NV; ++i) hv[k][i] = make_uint4(0, 0, 0, 0);
      sat::load_row<T, NV>(hv[k], hp_b + (size_t)k * D, lane, D);
    }
  } else {
    const uint4* src = reinterpret_cast<const uint4*>(hp_b);
    for (int j = tid; j < K * nvec; j += blockDim.x) s_hp[j] = src[j];
    __syncthreads();
  }

  int p = 0;
  for (int lr = warp; lr < nl; lr += nw) {
    sat::cp_async_wait<P - 1>();  // the oldest stage has landed
    uint4* stage = my + p * NV * 32;
    uint4 cv[NV];
    sat::read_row<NV>(cv, stage);
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if constexpr (HP_REGS) acc[k] += sat::score_vec<T>(cv[i], hv[k][i], wv[i]);
          else acc[k] += sat::score_vec<T>(cv[i], s_hp[k * nvec + j], wv[i]);
        }
      }
    }
    // the stage is used: refill it with the row P ahead
    const int nxt = lr + P * nw;
    if (nxt < nl) sat::copy_row<T, NV>(stage, ce_b + (size_t)nxt * D, lane, D);
    sat::cp_async_commit();
    p = (p + 1) & (P - 1);
    float mine = 0.f;  // lane k keeps score k
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = sat::warp_sum(acc[k]);
      if (lane == k) mine = v;
    }
    if (lane < K) e[((size_t)b * K + lane) * L + l0 + lr] = mine;
  }
}

template <typename T, int K, int NV>
cudaError_t launch_scores_stream_nv(const void* ce, const void* hp, const void* watt, float* e,
                                    int B, int L, int D, int S, int nt, cudaStream_t s) {
  const size_t smem = (size_t)(nt / 32) * stream_stages(NV) * NV * 512 +
                      (K * NV <= 8 ? 0 : (size_t)K * D * sizeof(T));
  auto kern = attention_scores_stream_kernel<T, K, NV>;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<B * S, nt, smem, s>>>(static_cast<const T*>(ce), static_cast<const T*>(hp),
                               static_cast<const T*>(watt), e, S, L, D);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_scores_stream_k(const void* ce, const void* hp, const void* watt, float* e,
                                   int B, int L, int D, int S, int nt, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (D % VEC || D > 4 * 32 * VEC) return cudaErrorInvalidValue;
  if (D <= 32 * VEC) return launch_scores_stream_nv<T, K, 1>(ce, hp, watt, e, B, L, D, S, nt, s);
  if (D <= 2 * 32 * VEC) return launch_scores_stream_nv<T, K, 2>(ce, hp, watt, e, B, L, D, S, nt, s);
  return launch_scores_stream_nv<T, K, 4>(ce, hp, watt, e, B, L, D, S, nt, s);
}

template <typename T>
cudaError_t launch_scores_stream(const void* ce, const void* hp, const void* watt, float* e, int B,
                                 int K, int L, int D, int S, int nt, cudaStream_t s) {
  switch (K) {
#define SAT_CASE(KK) \
  case KK:           \
    return launch_scores_stream_k<T, KK>(ce, hp, watt, e, B, L, D, S, nt, s);
    SAT_CASE(1) SAT_CASE(2) SAT_CASE(3) SAT_CASE(4)
    SAT_CASE(5) SAT_CASE(6) SAT_CASE(7) SAT_CASE(8)
#undef SAT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// --- the transposed form, an image over a cluster ----------------------------

constexpr int ST_CMAX = 8;  // blocks per image, at most (the portable cluster limit)
constexpr int ST_P = 4;     // ring stages per warp (a power of two)
constexpr int ST_U = 2;     // 8-byte ce^T vectors per lane per stage
constexpr int ST_BAR = 16;  // the two mbarriers (hp and w_att; f), and the alignment of what follows

// Dynamic shared memory of one block, in bytes; must agree with the kernel's
// layout (and with `st_smem_bytes` in ops/fused_decode_attention.py): the
// barriers, the block's Lc rows of f, the ce^T ring (NW warps x P stages x U
// vectors x 32 lanes x 8 bytes), which the warps' partial scores and then the
// partial context reuse once the scores are formed, hp[b] and w_att as they
// are, then in fp32 the scores, the block's max and sum of exp, and the
// cluster's weights.
__host__ __device__ __forceinline__ size_t st_reuse_bytes(int K, int Lc, int D) {
  const size_t ring = (size_t)NW * ST_P * ST_U * 32 * 8;
  const size_t red = sizeof(float) * NW * K * Lc, part = sizeof(float) * K * D;
  const size_t most = red > part ? red : part;
  return ring > most ? ring : most;
}
__host__ __device__ __forceinline__ size_t st_smem_bytes(int K, int Lc, int D, int es) {
  return ST_BAR + (size_t)Lc * D * es + st_reuse_bytes(K, Lc, D) + (size_t)(K + 1) * D * es +
         sizeof(float) * ((size_t)K * Lc + 2 * K + (size_t)K * ST_CMAX);
}

// two consecutive elements as fp32
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// acc[q] += tanh(ce[q] + h) * w over the VE elements (adjacent patches l) of
// the 8-byte vector `raw` of a ce^T row, against one element h of hp. bf16:
// ce + hp and its tanh two patches at a time (`add.bf16x2`,
// `tanh.approx.bf16x2`), rounded where the plain version rounds them; fp32:
// the ex2-based tanh. Products and sums in fp32.
__device__ __forceinline__ void st_score(float (&acc)[4], const uint2& raw, __nv_bfloat16 h, float w) {
  const __nv_bfloat162 h2 = __bfloat162bfloat162(h);
  const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float2 t = __bfloat1622float2(sat::tanh_bf16x2(__hadd2(c2[p], h2)));
    acc[2 * p] = fmaf(t.x, w, acc[2 * p]);
    acc[2 * p + 1] = fmaf(t.y, w, acc[2 * p + 1]);
  }
}
__device__ __forceinline__ void st_score(float (&acc)[2], const uint2& raw, float h, float w) {
  const float2 c = *reinterpret_cast<const float2*>(&raw);
  acc[0] = fmaf(sat::tanh_ex2(c.x + h), w, acc[0]);
  acc[1] = fmaf(sat::tanh_ex2(c.y + h), w, acc[1]);
}

// ce^T [B, D, L]. Block r of image b's cluster takes the Vc 8-byte vectors of
// l from r * Vc (Lc = Vc * VE patches). The warps split D; in a warp, lane i
// takes vector i % Vc of ce^T row i / Vc of each group of R = 32 / Vc rows
// (the lanes from R * Vc on idle), so one instruction covers R rows.
template <typename T, int K>
__global__ void __launch_bounds__(NT)
attention_st_cluster_kernel(const T* __restrict__ cet, const T* __restrict__ f,
                            const T* __restrict__ hp, const T* __restrict__ watt,
                            T* __restrict__ ctx, float* __restrict__ alpha, int L, int D, int Vc) {
  constexpr int VE = 8 / sizeof(T);  // elements of an 8-byte vector
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int Lc = Vc * VE;  // rows of f per block, the stride of the score arrays
  const int v0 = r * Vc;
  const int nv = max(0, min(L / VE, v0 + Vc) - v0);  // vectors of l of this block
  const int l0 = v0 * VE, nl = nv * VE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = 32 / Vc;
  const int v = lane % Vc, sub = lane / Vc;  // this lane's vector of l, and row of a group
  const bool live = sub < R && v < nv;

  extern __shared__ __align__(128) unsigned char smem[];
  T* s_f = reinterpret_cast<T*>(smem + ST_BAR);                       // [Lc][D]
  uint2* ring = reinterpret_cast<uint2*>(s_f + (size_t)Lc * D);       // [NW][P][U][32]
  const size_t reuse = st_reuse_bytes(K, Lc, D);
  float* s_red = reinterpret_cast<float*>(ring);                      // [NW][K][Lc], after the scores
  float* s_part = reinterpret_cast<float*>(ring);                     // [K][D], after the sum of s_red
  T* s_hp = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(ring) + reuse);  // [K][D]
  T* s_w = s_hp + K * D;                                              // [D]
  float* s_e = reinterpret_cast<float*>(s_w + D);                     // [K][Lc] scores, then exp(e - m)
  float* s_stat = s_e + K * Lc;                                       // [K] max, [K] sum of exp
  float* s_wgt = s_stat + 2 * K;                                      // [K][CMAX] the blocks' weights

  // hp[b] and w_att, then the block's rows of f: bulk copies, f in flight
  // through the scores
  const uint32_t bar_hp = sat::smem_u32(smem), bar_f = bar_hp + 8;
  if (tid == 0) {
    sat::mbar_init(bar_hp);
    sat::mbar_init(bar_f);
    sat::expect_bytes(bar_hp, (uint32_t)((K + 1) * D * sizeof(T)));
    sat::bulk_copy(bar_hp, s_hp, hp + (size_t)b * K * D, (uint32_t)(K * D * sizeof(T)));
    sat::bulk_copy(bar_hp, s_w, watt, (uint32_t)(D * sizeof(T)));
    const uint32_t f_bytes = (uint32_t)((size_t)nl * D * sizeof(T));
    sat::expect_bytes(bar_f, f_bytes);
    sat::bulk_copy(bar_f, s_f, f + ((size_t)b * L + l0) * D, f_bytes);
  }

  // this warp's rows d of ce^T, R per instruction and R * U per stage, on
  // their way into its ring: P stages ahead
  const int Dw = (D + NW - 1) / NW;
  const int dw0 = min(D, warp * Dw), dw1 = min(D, dw0 + Dw);
  const int steps = (dw1 - dw0 + R * ST_U - 1) / (R * ST_U);
  const T* src = cet + (size_t)b * D * L + l0 + v * VE;
  uint2* my = ring + (size_t)warp * ST_P * ST_U * 32 + lane;  // stage p, vector u: my[(p * U + u) * 32]
  auto fill = [&](int p, int j) {
#pragma unroll
    for (int u = 0; u < ST_U; ++u) {
      const int d = dw0 + (j * ST_U + u) * R + sub;
      if (live && d < dw1) sat::cp_async8(my + (p * ST_U + u) * 32, src + (size_t)d * L);
    }
    sat::cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < ST_P; ++p) fill(p, p);
  __syncthreads();  // the barriers are initialised
  sat::mbar_wait(bar_hp, 0);

  // 1. the partial scores over this warp's d, K x VE per lane in registers
  float acc[K][VE];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int q = 0; q < VE; ++q) acc[k][q] = 0.f;
  for (int j = 0; j < steps; ++j) {
    sat::cp_async_wait<ST_P - 1>();  // step j has landed in stage j % P
    const int p = j & (ST_P - 1);
#pragma unroll
    for (int u = 0; u < ST_U; ++u) {
      const int d = dw0 + (j * ST_U + u) * R + sub;
      if (live && d < dw1) {
        const uint2 raw = my[(p * ST_U + u) * 32];
        const float w = to_f(s_w[d]);
#pragma unroll
        for (int k = 0; k < K; ++k) st_score(acc[k], raw, s_hp[k * D + d], w);
      }
    }
    fill(p, j + ST_P);  // the stage is used: refill it P steps ahead
  }
  // the R lanes of one vector of l meet in the first, then the warps, once,
  // in shared memory (over the ring, which every warp has finished with)
  for (int g = 1; g < R; ++g) {
    const int from = min(31, lane + g * Vc);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int q = 0; q < VE; ++q) {
        const float o = __shfl_sync(0xffffffffu, acc[k][q], from);
        if (sub == 0) acc[k][q] += o;
      }
  }
  __syncthreads();
  if (sub == 0 && live) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int q = 0; q < VE; ++q) s_red[(warp * K + k) * Lc + v * VE + q] = acc[k][q];
  }
  __syncthreads();
  for (int i = tid; i < K * nl; i += NT) {
    const int k = i / nl, l = i - k * nl;
    float e = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) e += s_red[(w * K + k) * Lc + l];
    s_e[k * Lc + l] = e;
  }
  __syncthreads();

  // 2. the block's max and sum of exp per beam; s_e becomes exp(e - m)
  if (warp < K) {
    float* e = s_e + warp * Lc;
    float m = -INFINITY;
    for (int l = lane; l < nl; l += 32) m = fmaxf(m, e[l]);
    m = sat::warp_max(m);
    float s = 0.f;
    for (int l = lane; l < nl; l += 32) {
      const float pl = expf(e[l] - m);
      e[l] = pl;
      s += pl;
    }
    s = sat::warp_sum(s);
    if (lane == 0) {
      s_stat[warp] = m;
      s_stat[K + warp] = s;
    }
  }
  __syncthreads();

  // 3. the block's context over its rows of f, all K in fp32
  sat::mbar_wait(bar_f, 0);
  for (int d = 2 * tid; d < D; d += 2 * NT) {
    float a0[K], a1[K];
#pragma unroll
    for (int k = 0; k < K; ++k) a0[k] = a1[k] = 0.f;
    for (int l = 0; l < nl; ++l) {
      const float2 fv = load2(s_f + (size_t)l * D + d);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a0[k] = fmaf(s_e[k * Lc + l], fv.x, a0[k]);
        a1[k] = fmaf(s_e[k * Lc + l], fv.y, a1[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s_part[k * D + d] = a0[k];
      s_part[k * D + d + 1] = a1[k];
    }
  }

  // 4. the blocks of the image meet once, through distributed shared memory:
  // block q's share weighs exp(m_q - m) / s under the image's max m and sum s
  cluster.sync();
  if (warp < K) {
    float mq = -INFINITY, sq = 0.f;
    if (lane < C) {
      const float* st = cluster.map_shared_rank(s_stat, lane);
      mq = st[warp];
      sq = st[K + warp];
    }
    const float mg = sat::warp_max(mq);
    const float wq = sq > 0.f ? expf(mq - mg) : 0.f;
    const float sg = sat::warp_sum(sq * wq);
    if (lane < C) s_wgt[warp * ST_CMAX + lane] = wq / sg;
  }
  __syncthreads();
  for (int i = tid; i < K * nl; i += NT) {
    const int k = i / nl, l = i - k * nl;
    alpha[((size_t)b * K + k) * L + l0 + l] = s_e[k * Lc + l] * s_wgt[k * ST_CMAX + r];
  }
  // block r sums the C contexts of its slice of D
  const int Dc = (D + C - 1) / C;
  const int dlo = r * Dc, nd = max(0, min(D, dlo + Dc) - dlo);
  const float inv_l = 1.f / (float)L;
  for (int i = tid; i < K * nd; i += NT) {
    const int k = i / nd, d = dlo + i - k * nd;
    float c = 0.f;
    for (int q = 0; q < C; ++q) c = fmaf(s_wgt[k * ST_CMAX + q], cluster.map_shared_rank(s_part, q)[k * D + d], c);
    ctx[((size_t)b * K + k) * D + d] = from_f<T>(c * inv_l);
  }
  cluster.sync();  // no block leaves while another still reads its context
}

template <typename T, int K>
cudaError_t launch_st_cluster_k(const void* cet, const void* f, const void* hp, const void* watt,
                                void* ctx, float* alpha, int B, int L, int D, int C, cudaStream_t s) {
  constexpr int VE = 8 / sizeof(T);
  const int Vc = (L / VE + C - 1) / C;
  if (L % VE || (D * sizeof(T)) % 16 || Vc > 32) return cudaErrorInvalidValue;
  const size_t smem = st_smem_bytes(K, Vc * VE, D, sizeof(T));
  auto kern = attention_st_cluster_kernel<T, K>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(cet), static_cast<const T*>(f),
                         static_cast<const T*>(hp), static_cast<const T*>(watt),
                         static_cast<T*>(ctx), alpha, L, D, Vc);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_st_cluster(const void* cet, const void* f, const void* hp, const void* watt,
                              void* ctx, float* alpha, int B, int K, int L, int D, int C,
                              cudaStream_t s) {
  switch (K) {
#define SAT_CASE(KK) \
  case KK:           \
    return launch_st_cluster_k<T, KK>(cet, f, hp, watt, ctx, alpha, B, L, D, C, s);
    SAT_CASE(1) SAT_CASE(2) SAT_CASE(3) SAT_CASE(4)
    SAT_CASE(5) SAT_CASE(6) SAT_CASE(7) SAT_CASE(8)
#undef SAT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int K>
cudaError_t launch_st_k(const void* cet, const void* f, const void* hp, const void* watt,
                        void* ctx, float* alpha, int B, int L, int D, cudaStream_t s) {
  const size_t smem = (size_t)(K * D + D + K * L) * sizeof(float);
  auto kern = attention_st_kernel<T, K>;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<B, NT, smem, s>>>(static_cast<const T*>(cet), static_cast<const T*>(f),
                           static_cast<const T*>(hp), static_cast<const T*>(watt),
                           static_cast<T*>(ctx), alpha, L, D);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_grid2(const void* ce, const void* f, const void* hp, const void* watt,
                         void* ctx, float* alpha, int B, int K, int L, int D, cudaStream_t s) {
  const size_t smem = (size_t)(2 * D + L) * sizeof(float);
  auto kern = attention_grid2_kernel<T, VEC>;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<B * K, NT, smem, s>>>(static_cast<const T*>(ce), static_cast<const T*>(f),
                               static_cast<const T*>(hp), static_cast<const T*>(watt),
                               static_cast<T*>(ctx), alpha, K, L, D);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_scores(const void* ce, const void* hp, const void* watt, float* e, int B, int K,
                          int L, int D, cudaStream_t s) {
  switch (K) {
#define SAT_CASE(KK) \
  case KK:           \
    return launch_scores_k<T, KK, VEC>(ce, hp, watt, e, B, L, D, s);
    SAT_CASE(1) SAT_CASE(2) SAT_CASE(3) SAT_CASE(4)
    SAT_CASE(5) SAT_CASE(6) SAT_CASE(7) SAT_CASE(8)
#undef SAT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_st(const void* cet, const void* f, const void* hp, const void* watt, void* ctx,
                      float* alpha, int B, int K, int L, int D, cudaStream_t s) {
  switch (K) {
#define SAT_CASE(KK) \
  case KK:           \
    return launch_st_k<T, KK>(cet, f, hp, watt, ctx, alpha, B, L, D, s);
    SAT_CASE(1) SAT_CASE(2) SAT_CASE(3) SAT_CASE(4)
    SAT_CASE(5) SAT_CASE(6) SAT_CASE(7) SAT_CASE(8)
#undef SAT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int K, int L, int D) {
  return B <= 0 || L <= 0 || D <= 0 || K < 1 || K > KMAX;
}

}  // namespace

// Every entry point: dtype 0 = float32, 1 = bfloat16; vec 1 when D is a
// multiple of the 16-byte vector width and ce is 16-byte aligned. Each
// returns a cudaError_t.

// ce [B, L, D], hp [B, K, D], w_att [D] -> e [B, K, L] fp32.
extern "C" int sat_attention_scores(const void* ce, const void* hp, const void* watt, float* e,
                                    int B, int K, int L, int D, int dtype, int vec,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, K, L, D)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return (int)(vec ? launch_scores<float, 4>(ce, hp, watt, e, B, K, L, D, s)
                     : launch_scores<float, 1>(ce, hp, watt, e, B, K, L, D, s));
  }
  if (dtype == 1) {
    return (int)(vec ? launch_scores<__nv_bfloat16, 8>(ce, hp, watt, e, B, K, L, D, s)
                     : launch_scores<__nv_bfloat16, 1>(ce, hp, watt, e, B, K, L, D, s));
  }
  return (int)cudaErrorInvalidValue;
}

// The streaming design: ce [B, L, D], hp [B, K, D], w_att [D] -> e [B, K, L]
// fp32, `slices` blocks of `threads` threads (a multiple of 32 up to 256) per
// image. Needs D a multiple of the 16-byte vector width, at most 128 vectors
// per row, and ce, hp and w_att 16-byte aligned.
extern "C" int sat_attention_scores_stream(const void* ce, const void* hp, const void* watt,
                                           float* e, int B, int K, int L, int D, int dtype,
                                           int slices, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, K, L, D) || slices < 1 || threads < 32 || threads > NT || threads % 32 ||
      (long long)B * slices > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_scores_stream<float>(ce, hp, watt, e, B, K, L, D, slices, threads, s);
  if (dtype == 1)
    return (int)launch_scores_stream<__nv_bfloat16>(ce, hp, watt, e, B, K, L, D, slices, threads, s);
  return (int)cudaErrorInvalidValue;
}

// ce^T [B, D, L], f [B, L, D], hp [B, K, D], w_att [D] -> ctx [B, K, D],
// alpha [B, K, L] fp32. Loads are element-wise, so no vec flag.
extern "C" int sat_attention_beam_st(const void* cet, const void* f, const void* hp,
                                     const void* watt, void* ctx, float* alpha, int B, int K,
                                     int L, int D, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, K, L, D)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_st<float>(cet, f, hp, watt, ctx, alpha, B, K, L, D, s);
  if (dtype == 1) {
    return (int)launch_st<__nv_bfloat16>(cet, f, hp, watt, ctx, alpha, B, K, L, D, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The cluster design of the transposed form: ce^T [B, D, L], f [B, L, D], hp
// [B, K, D], w_att [D] -> ctx [B, K, D], alpha [B, K, L] fp32, `cluster`
// blocks (1..8) per image. Needs L * sizeof(T) a multiple of 8 and ce^T
// 8-byte aligned, D * sizeof(T) a multiple of 16 and f, hp and w_att 16-byte
// aligned, at most 32 vectors of l per block, and a block's layout within
// shared memory.
extern "C" int sat_attention_beam_st_cluster(const void* cet, const void* f, const void* hp,
                                             const void* watt, void* ctx, float* alpha, int B,
                                             int K, int L, int D, int dtype, int cluster,
                                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, K, L, D) || cluster < 1 || cluster > ST_CMAX ||
      (long long)B * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_st_cluster<float>(cet, f, hp, watt, ctx, alpha, B, K, L, D, cluster, s);
  if (dtype == 1)
    return (int)launch_st_cluster<__nv_bfloat16>(cet, f, hp, watt, ctx, alpha, B, K, L, D, cluster, s);
  return (int)cudaErrorInvalidValue;
}

// The first design of the (image, beam) grid, for the shapes the one-pass
// kernel of additive_attention.cu does not take: ce, f [B, L, D], hp [B, K,
// D], w_att [D] -> ctx [B, K, D], alpha [B, K, L] fp32, one block per (image,
// beam).
extern "C" int sat_attention_beam_grid2(const void* ce, const void* f, const void* hp,
                                        const void* watt, void* ctx, float* alpha, int B, int K,
                                        int L, int D, int dtype, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, K, L, D) || (long long)B * K > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return (int)(vec ? launch_grid2<float, 4>(ce, f, hp, watt, ctx, alpha, B, K, L, D, s)
                     : launch_grid2<float, 1>(ce, f, hp, watt, ctx, alpha, B, K, L, D, s));
  }
  if (dtype == 1) {
    return (int)(vec ? launch_grid2<__nv_bfloat16, 8>(ce, f, hp, watt, ctx, alpha, B, K, L, D, s)
                     : launch_grid2<__nv_bfloat16, 1>(ce, f, hp, watt, ctx, alpha, B, K, L, D, s));
  }
  return (int)cudaErrorInvalidValue;
}
