// Additive (Bahdanau) attention over an image's patch grid, one row per
// image (K = 1), on Hopper (sm_90a).
//
// Replaces: show_and_tell_tpu/ops/fused_attention.py `_attn_kernel` (greedy
// decoding, and the forward of training's attention). The beam-shared form
// (K beams per image) is csrc/decode_attention.cu's; the kernel below is
// written for any K, and only its K = 1 instance is built.
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
// Design: one block per image. Every ce and f element is read from device
// memory exactly once, whatever K: a warp takes one patch row l, loads
// ce[b, l, :] (in 16-byte vectors where D and the pointers allow it) and
// forms the K scores from it, with hp and w_att held in shared memory as
// fp32. The softmax runs per beam over L in shared memory, and then the
// threads stream f[b, :, d] once and accumulate all K contexts. No [B, L, D]
// or [B, K, L, D] intermediate exists and L needs no padding: L = 196 and
// L = 13 are loop bounds. tanhf is the precise one (tanh.approx.f32 has about
// 2^-11 relative error and fails the fp32 tolerance); the approximate form is
// a lever for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

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
