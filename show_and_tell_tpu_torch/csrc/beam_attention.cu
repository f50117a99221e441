// The three other forms of the beam-shared decode attention, on Hopper
// (sm_90a). Each replaces one TPU kernel of
// show_and_tell_tpu/ops/fused_decode_attention.py:
//   - attention_scores_kernel: `_score_kernel` (scores only, the first half of
//     `attention_beam_hybrid`);
//   - attention_st_kernel: `_kernel_st` (ce transposed to [B, D, L]);
//   - attention_grid2_kernel: `_kernel_grid2` (an (image, beam) grid).
//
// They compute the function of additive_attention.cu: for image b and beam k,
//     e[k, l]   = sum_d tanh(ce[b, l, d] + hp[b, k, d]) * w_att[d]   (fp32)
//     alpha[k]  = softmax_l(e[k]);  ctx[k, d] = sum_l alpha[k, l] f[b, l, d] / L
// with every product and sum in fp32. The TPU kernels' bf16 products and
// sums (the `s16` and `st` score forms) are not reproduced: on Hopper the
// score forms are one function.
//
// Bounds on an H100 at the serving shape (B=256, K=3, L=196, D=512, bf16):
// the 77.1 M tanh of the scores, at tens of instructions each for the precise
// tanhf, against 51.4 MB of ce (scores only) or 102.8 MB of ce and f read
// once at 3.35 TB/s (15.3 us and 30.7 us). All three sit near the line
// between the two bounds, like the fused kernel.
//
// Design:
//   - scores only: one block per image; the score phase of the fused kernel
//     (a warp per patch row, ce[b] read once for all K beams, hp and w_att in
//     shared memory as fp32), with the scores written straight to e. f is
//     never read.
//   - transposed: one block per image; threads run along l, so each row
//     ce^T[b, d, :] is a coalesced read, and each thread loops over d with
//     its K scores in registers: the score needs no warp reduction, which is
//     what the TPU layout was for. Softmax and context are the fused
//     kernel's.
//   - (image, beam) grid: one block per (image, beam) pair, the beam
//     innermost (blockIdx.x = b * K + k), as the TPU grid runs k innermost.
//     The K blocks of one image run close together in time, so the second
//     and third reads of ce[b] and f[b] (200 KB each in bf16) can come from
//     the 50 MB L2; device memory may still see up to K reads. Three times
//     the blocks of the fused kernel (768 against 256 at the serving shape).
//
// The phases below are those of additive_attention.cu's kernel, written as
// device functions that these kernels share. That kernel keeps its own
// copy: moved onto these functions it compiled to other code (K=3 about
// 11 % faster, K=1 about 8 % slower on the H100), and the serving path it
// runs is left as it was.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

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

// ce, f [B, L, D], hp [B, K, D], w_att [D] -> ctx [B, K, D], alpha [B, K, L]
// fp32, one block per (image, beam).
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
