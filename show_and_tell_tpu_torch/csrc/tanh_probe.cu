// The tanh probe: the floor of the attention's score pass, on Hopper (sm_90a).
//
// Replaces: benchmarks/attn_kernel_bench.py `kern` in `micro_tanh` (the TPU's
// probe of its vector unit: just tanh(ce + hp_k) summed, no softmax and no
// context).
//
//     out[b, d] = sum_k sum_l tanh(ce[b, l, d] + hp[b, k, d])          (fp32)
// ce: [B, L, D]; hp: [B, K, D]; both fp32 or both bf16; out [B, D] fp32. For
// bf16 inputs the sum ce + hp and its tanh are rounded to bf16, as the TPU
// kernel's body forms them in the input type; the accumulation is fp32. L is
// a loop bound and needs no padding.
//
// Bound on an H100 at the serving shape (B=256, K=3, L=196, D=512, bf16): ce
// is 51.4 MB, read once at 3.35 TB/s in 15.3 us. The 77.1 M tanh run on the
// special-function units, 16 operations per clock per SM: at 1.98 GHz on 132
// SMs, 18.4 us at one operation per tanh (`tanh.approx.f32`, and also
// `tanh.approx.bf16x2`, which the compiler turns into two MUFU.TANH.BF16, one
// per half: no form does two tanh per operation), 36.9 us by `ex2.approx` +
// `rcp.approx`. So the tanh, not the bytes, bound the probe and every score
// pass of K = 3. What the card reaches of that rate is what the probe
// measures, so the form of the tanh is an argument:
//   0  tanh.approx.bf16x2 on add.bf16x2 (bf16 inputs only)
//   1  tanh.approx.f32
//   2  1 - 2 / (1 + 2^(2x log2 e)) from ex2.approx and rcp.approx
//   3  the precise tanhf
//
// Design: a block is 64 threads along d times 4 groups of patch rows. A
// thread owns one 16-byte vector of d (8 bf16 or 4 fp32 elements; one element
// where D or the alignment rule vectors out) and walks its rows 7 at a time,
// the next 7 ce vectors on their way while it sums the tanh of these, so 7
// to 14 loads per thread are in flight throughout, and each hp vector, read
// from shared memory, serves 7 rows. ce is read from device memory exactly
// once, whatever K. The row groups' sums meet in shared memory at the end.

#include "sat_common.cuh"

namespace {

constexpr int TX = 64;  // threads along d
constexpr int TY = 4;   // groups of patch rows
constexpr int NT = TX * TY;
constexpr int U = 7;    // rows per thread in flight
constexpr int KMAX = 8;

enum Form { BF16X2 = 0, APPROX_F32 = 1, EX2_RCP = 2, PRECISE = 3 };

template <int FORM>
__device__ __forceinline__ float tanh_f32(float x) {
  if constexpr (FORM == APPROX_F32) return sat::tanh_approx_f32(x);
  else if constexpr (FORM == EX2_RCP) return sat::tanh_ex2(x);
  else return tanhf(x);
}

// acc[q] += tanh(ce[q] + hp[q]) over the VEC elements of two raw vectors.
template <typename T, int VEC, int FORM>
__device__ __forceinline__ void add_tanh(float (&acc)[VEC], const T* ce, const T* hp) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (FORM == BF16X2) {  // packed pairs
      if constexpr (VEC == 1) {
        const __nv_bfloat162 s = sat::tanh_bf16x2(
            __hadd2(__halves2bfloat162(ce[0], ce[0]), __halves2bfloat162(hp[0], hp[0])));
        acc[0] += __low2float(s);
      } else {
        const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(ce);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(hp);
#pragma unroll
        for (int p = 0; p < VEC / 2; ++p) {
          const float2 t = __bfloat1622float2(sat::tanh_bf16x2(__hadd2(c2[p], h2[p])));
          acc[2 * p] += t.x;
          acc[2 * p + 1] += t.y;
        }
      }
    } else {
      // the sum and the tanh rounded to bf16, the tanh itself in fp32
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float s = __bfloat162float(__hadd(ce[q], hp[q]));
        acc[q] += __bfloat162float(__float2bfloat16(tanh_f32<FORM>(s)));
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] += tanh_f32<FORM>(ce[q] + hp[q]);
  }
}

// VEC elements that load and store as one vector.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC, int FORM>
__global__ void __launch_bounds__(NT)
tanh_probe_kernel(const T* __restrict__ ce, const T* __restrict__ hp, float* __restrict__ out,
                  int K, int L, int D) {
  using P = Pack<T, VEC>;
  // hp[b, :, this block's d range] as it is, then the row groups' sums
  __shared__ __align__(16) unsigned char s_hp_raw[KMAX * TX * sizeof(P)];
  __shared__ float s_sum[TY][TX * VEC];
  T* s_hp = reinterpret_cast<T*>(s_hp_raw);

  const int b = blockIdx.y;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int d0 = (blockIdx.x * TX + tx) * VEC;  // this thread's first element
  const bool live = d0 < D;

  for (int i = threadIdx.x; i < K * TX * VEC; i += NT) {
    const int k = i / (TX * VEC), d = blockIdx.x * TX * VEC + i % (TX * VEC);
    if (d < D) s_hp[i] = hp[((size_t)b * K + k) * D + d];
  }
  __syncthreads();

  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
  if (live) {
    const T* col = ce + (size_t)b * L * D + d0;
    // rows l0, l0 + TY, ... of this thread's vector
    auto load = [&](P (&rows)[U], int l0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int l = l0 + u * TY;
        if (l < L) rows[u] = *reinterpret_cast<const P*>(col + (size_t)l * D);
      }
    };
    auto add = [&](const P (&rows)[U], int l0) {
      if (l0 >= L) return;
      for (int k = 0; k < K; ++k) {
        const P h = *reinterpret_cast<const P*>(s_hp + (k * TX + tx) * VEC);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (l0 + u * TY < L) add_tanh<T, VEC, FORM>(acc, rows[u].v, h.v);
      }
    };
    // two batches of U rows: one on its way while the other is summed
    P ra[U], rb[U];
    load(ra, ty);
    for (int l0 = ty; l0 < L; l0 += 2 * TY * U) {
      load(rb, l0 + TY * U);
      add(ra, l0);
      load(ra, l0 + 2 * TY * U);
      add(rb, l0 + TY * U);
    }
  }
#pragma unroll
  for (int q = 0; q < VEC; ++q) s_sum[ty][tx * VEC + q] = acc[q];
  __syncthreads();
  if (ty == 0 && live) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < TY; ++g) s += s_sum[g][tx * VEC + q];
      out[(size_t)b * D + d0 + q] = s;
    }
  }
}

template <typename T, int VEC, int FORM>
cudaError_t launch(const void* ce, const void* hp, float* out, int B, int K, int L, int D,
                   cudaStream_t s) {
  const dim3 grid((D + TX * VEC - 1) / (TX * VEC), B);
  tanh_probe_kernel<T, VEC, FORM><<<grid, NT, 0, s>>>(static_cast<const T*>(ce),
                                                      static_cast<const T*>(hp), out, K, L, D);
  return cudaGetLastError();
}

template <typename T, int FORM>
cudaError_t launch_vec(const void* ce, const void* hp, float* out, int B, int K, int L, int D,
                       int vec, cudaStream_t s) {
  return vec ? launch<T, 16 / sizeof(T), FORM>(ce, hp, out, B, K, L, D, s)
             : launch<T, 1, FORM>(ce, hp, out, B, K, L, D, s);
}

}  // namespace

// ce [B, L, D], hp [B, K, D] -> out [B, D] fp32. dtype: 0 = float32, 1 =
// bfloat16. form: see `Form` (0 needs bfloat16). vec: 1 when D is a multiple
// of the 16-byte vector width and ce and hp are 16-byte aligned. Returns a
// cudaError_t.
extern "C" int sat_tanh_probe(const void* ce, const void* hp, float* out, int B, int K, int L,
                              int D, int dtype, int form, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || L <= 0 || D <= 0 || K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (form) {
      case APPROX_F32: return (int)launch_vec<float, APPROX_F32>(ce, hp, out, B, K, L, D, vec, s);
      case EX2_RCP: return (int)launch_vec<float, EX2_RCP>(ce, hp, out, B, K, L, D, vec, s);
      case PRECISE: return (int)launch_vec<float, PRECISE>(ce, hp, out, B, K, L, D, vec, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    switch (form) {
      case BF16X2: return (int)launch_vec<bf16, BF16X2>(ce, hp, out, B, K, L, D, vec, s);
      case APPROX_F32: return (int)launch_vec<bf16, APPROX_F32>(ce, hp, out, B, K, L, D, vec, s);
      case EX2_RCP: return (int)launch_vec<bf16, EX2_RCP>(ce, hp, out, B, K, L, D, vec, s);
      case PRECISE: return (int)launch_vec<bf16, PRECISE>(ce, hp, out, B, K, L, D, vec, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
