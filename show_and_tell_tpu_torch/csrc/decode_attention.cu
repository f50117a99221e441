// Beam-shared additive attention over an image's patch grid, for K beams that
// share the image, on Hopper (sm_90a): a thread-block cluster per image.
//
// Replaces: show_and_tell_tpu/ops/fused_decode_attention.py `_kernel` with
// `_cmxu_context` (K beams per image: beam search; every `s*_c*` variant).
//
// For image b and beam k:
//     e[k, l]   = sum_d tanh(ce[b, l, d] + hp[b, k, d]) * w_att[d]   (fp32)
//     alpha[k]  = softmax_l(e[k])                                    (fp32)
//     ctx[k, d] = sum_l alpha[k, l] * f[b, l, d] / L
// ce, f: [B, L, D]; hp: [B, K, D]; w_att: [D]; all fp32 or all bf16.
// Outputs ctx [B, K, D] in that type and alpha [B, K, L] in fp32. As in the
// reference, alpha is rounded to the compute type before the context sum.
//
// Bound on an H100 at the serving shape (B=256, K=3, L=196, D=512, bf16): ce
// and f are 102.8 MB, read once at 3.35 TB/s in 30.7 us, larger than the 50
// MB L2, so they arrive cold. The scores take 77.1 M tanh; at 16 MUFU
// operations per clock per SM (1.98 GHz) one tanh per operation needs 18 us,
// two per operation (bf16x2) 9 us: bytes set the pace.
//
// Design:
//   - Each image is split over a cluster of C blocks (C from the wrapper,
//     ops/fused_decode_attention.py `beam_plan`: 4 at L=196). Block r takes
//     a contiguous share of the L patch rows, so at B=256 the card runs
//     1,024 blocks instead of 256 and every SM holds a share of the images.
//   - At its start one thread of each block issues one bulk asynchronous
//     copy (`cp.async.bulk`, completion on an mbarrier) of the block's f
//     rows into shared memory, so f is in flight while the scores are
//     formed. ce streams from device memory in 16-byte vectors, each warp's
//     next row in flight while it scores the current one; hp and w_att
//     reach shared memory from 16-byte vectors, all in flight at once.
//     Shapes whose rows are not 16-byte multiples, misaligned operands, or
//     a share of f too large for shared memory, read element by element
//     instead.
//   - Scores: a warp per patch row, each ce row read once for all K beams.
//     bf16: hp stays bf16 in shared memory, and ce + hp and its tanh are
//     formed two at a time in bf16 (`add.bf16x2`, `tanh.approx.bf16x2`: one
//     MUFU operation per two tanh), rounded where the plain version rounds
//     them; the products with w_att and the sum over d are fp32. fp32: all in
//     fp32, tanh as 1 - 2 / (1 + 2^(2x log2 e)) from `ex2.approx` and
//     `rcp.approx` (two MUFU operations, absolute error below 5e-7), since
//     `tanh.approx.f32` (~2^-11 relative error) fails the fp32 tolerance.
//   - Softmax: each block writes its per-beam max and sum of exp; after a
//     cluster barrier every block reads the C pairs through distributed
//     shared memory and forms alpha for its own rows.
//   - Context: each block forms the K partial sums over its rows from its f
//     rows in shared memory; after a second cluster barrier block r adds the
//     C partials of a D/C slice of ctx through distributed shared memory.
//     A last cluster barrier keeps every block alive until the others have
//     read it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;        // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int KMAX = 8;        // largest K (beam width) instantiated
constexpr int CMAX = 8;        // largest cluster (the portable limit)
constexpr int BAR_BYTES = 128; // f's barrier, and the alignment of what follows

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

// two consecutive elements as fp32
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// fp32: 1 - 2 / (1 + e^(2x)), from ex2.approx and rcp.approx
__device__ __forceinline__ float tanh_ex2(float x) {
  float t, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(x * 2.8853900817779268f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + t));
  return fmaf(-2.f, r, 1.f);
}

__device__ __forceinline__ float tanh_mufu(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the scalar (DIRECT) path's tanh: tanh.approx in bf16, tanh_ex2 in fp32
template <typename T>
__device__ __forceinline__ float fast_tanh(float x) {
  if constexpr (sizeof(T) == 2) return tanh_mufu(x);
  else return tanh_ex2(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    // a copy that never lands traps (a launch error) after ~2^34 cycles
    // instead of holding the card
    if (!done) {
      if (t0 == 0) t0 = clock64();
      else if (clock64() - t0 > (1LL << 34)) __trap();
    }
  } while (!done);
}

// Arrive on `bar` expecting `bytes`, and copy them from global `src` to
// shared `dst` (both 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(uint32_t bar, void* dst, const void* src, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// How a block gets its ce and f rows:
//   DIRECT: from device memory, element by element (any D, any alignment);
//   F_BULK: f by one bulk copy into shared memory, issued at the start; ce,
//           hp and w_att from device memory in 16-byte vectors, each warp's
//           next row in flight while it scores the current one. Needs
//           D * sizeof(T) a multiple of 16 and ce, f, hp, w_att 16-byte
//           aligned.
enum Mode { DIRECT = 0, F_BULK = 1 };

// Dynamic shared memory of one block; must agree with the kernel's layout
// (and with `beam_smem_bytes` in ops/fused_decode_attention.py).
__host__ __device__ __forceinline__ size_t smem_bytes(int K, int Lc, int D, int es, int mode) {
  const size_t rows = mode == F_BULK ? (size_t)Lc * D * es : 0;  // f
  return BAR_BYTES + rows + sizeof(float) * ((size_t)K * D + D + (size_t)K * Lc + 2 * K);
}

// Where element d of w_att sits (as fp32) in shared memory in the vector
// modes. A lane's 16-byte ce vector holds VEC elements; for bf16 (VEC = 8)
// its two float4 of w_att are stored D/2 apart, so that the lanes of a warp
// read consecutive float4 (no bank conflicts).
template <int VEC>
__device__ __forceinline__ int slot(int d, int D) {
  if constexpr (VEC == 8) return ((d & 4) ? (D >> 1) : 0) + ((d >> 3) << 2) + (d & 3);
  else return d;
}

// tanh of two bf16 in one MUFU operation
__device__ __forceinline__ __nv_bfloat162 tanh_bf16x2(__nv_bfloat162 x) {
  uint32_t y;
  asm("tanh.approx.bf16x2 %0, %1;" : "=r"(y) : "r"(*reinterpret_cast<const uint32_t*>(&x)));
  return *reinterpret_cast<const __nv_bfloat162*>(&y);
}

// acc[k] += sum over the VEC elements of ce vector `raw` (row elements d0..)
// of tanh(ce + hp[k]) * w, with hp and w from shared memory. bf16: hp is
// kept in bf16 and ce + hp and its tanh are formed two at a time in bf16,
// rounded where the plain version rounds them; the products and the sum
// over d are fp32. fp32: all in fp32, hp as fp32.
template <typename T, int K>
__device__ __forceinline__ void score_vec(float (&acc)[K], const uint4& raw, const float* s_hp,
                                          const float* s_w, int d0, int D) {
  constexpr int VEC = 16 / sizeof(T);
  if constexpr (VEC == 8) {
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 wa = *reinterpret_cast<const float4*>(s_w + slot<8>(d0, D));
    const float4 wb = *reinterpret_cast<const float4*>(s_w + slot<8>(d0 + 4, D));
    const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const __nv_bfloat16* hp16 = reinterpret_cast<const __nv_bfloat16*>(s_hp);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint4 hr = *reinterpret_cast<const uint4*>(hp16 + k * D + d0);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hr);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float2 t = __bfloat1622float2(tanh_bf16x2(__hadd2(c2[p], h2[p])));
        acc[k] = fmaf(t.x, w[2 * p], acc[k]);
        acc[k] = fmaf(t.y, w[2 * p + 1], acc[k]);
      }
    }
  } else {
    const T* v = reinterpret_cast<const T*>(&raw);
    const float4 w4 = *reinterpret_cast<const float4*>(s_w + d0);
    const float c0 = to_f(v[0]), c1 = to_f(v[1]), c2 = to_f(v[2]), c3 = to_f(v[3]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 h4 = *reinterpret_cast<const float4*>(s_hp + k * D + d0);
      acc[k] += fast_tanh<T>(c0 + h4.x) * w4.x + fast_tanh<T>(c1 + h4.y) * w4.y +
                fast_tanh<T>(c2 + h4.z) * w4.z + fast_tanh<T>(c3 + h4.w) * w4.w;
    }
  }
}

constexpr int P = 2;  // ce rows per warp in flight

// Issue the loads of the NV 16-byte vectors per lane of `row` from element
// `base` on.
template <typename T, int NV>
__device__ __forceinline__ void load_row(uint4 (&r)[NV], const T* row, int base, int lane, int D) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d0 = base + (i * 32 + lane) * VEC;
    if (d0 < D) r[i] = *reinterpret_cast<const uint4*>(row + d0);
  }
}

template <typename T, int K, int MODE>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const T* __restrict__ ce, const T* __restrict__ f,
                        const T* __restrict__ hp, const T* __restrict__ watt,
                        T* __restrict__ ctx, float* __restrict__ alpha, int L, int D) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int Lc = (L + C - 1) / C;
  const int l0 = r * Lc;
  const int nl = max(0, min(L, l0 + Lc) - l0);  // rows of this block

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* fbar = reinterpret_cast<uint64_t*>(smem);  // f's barrier
  T* s_f = reinterpret_cast<T*>(smem + BAR_BYTES);     // [Lc][D] (F_BULK)
  float* s_hp = reinterpret_cast<float*>(s_f + (MODE == F_BULK ? (size_t)Lc * D : 0));  // [K][D]
  float* s_part = s_hp;                                // [K][D] partial ctx, after the scores
  float* s_w = s_hp + K * D;                           // [D]
  float* s_e = s_w + D;                                // [K][Lc] scores, then alpha
  float* s_stat = s_e + K * Lc;                        // [K] max, [K] sum of exp

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)b * L + l0;  // first patch row of this block
  const T* hp_b = hp + (size_t)b * K * D;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NV = 16 / VEC;  // vectors per lane that cover D = 512 in one pass
  uint4 buf[P][NV];             // ce rows in flight (F_BULK)

  if constexpr (MODE == F_BULK) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(fbar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      bulk_load(smem_u32(fbar), s_f, f + row0 * D, (uint32_t)(nl * D * sizeof(T)));
    }
    // each warp's first P rows of ce, in flight while hp and w_att arrive
    if (D <= NV * 32 * VEC) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (warp + p * NW < nl) load_row<T>(buf[p], ce + (row0 + warp + p * NW) * D, 0, lane, D);
    }
    // hp[b] and w_att into shared memory, NV vectors per thread in flight
    // at once
    const int nv_hp = K * D / VEC, nv = nv_hp + D / VEC;
    for (int base = 0; base < nv; base += NV * NT) {
      uint4 raw[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = base + i * NT + tid;
        if (j < nv)
          raw[i] = *reinterpret_cast<const uint4*>(j < nv_hp ? hp_b + j * VEC : watt + (j - nv_hp) * VEC);
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = base + i * NT + tid;
        if (j >= nv) continue;
        const T* v = reinterpret_cast<const T*>(&raw[i]);
        if (j < nv_hp) {  // hp as it is in bf16, as fp32 in fp32
          if constexpr (VEC == 8) reinterpret_cast<uint4*>(s_hp)[j] = raw[i];
          else reinterpret_cast<float4*>(s_hp)[j] = make_float4(v[0], v[1], v[2], v[3]);
        } else {
          const int d = (j - nv_hp) * VEC;
#pragma unroll
          for (int q = 0; q < VEC; ++q) s_w[slot<VEC>(d + q, D)] = to_f(v[q]);
        }
      }
    }
  } else {
    for (int i = tid; i < K * D; i += NT) s_hp[i] = to_f(hp_b[i]);
    for (int i = tid; i < D; i += NT) s_w[i] = to_f(watt[i]);
  }
  __syncthreads();

  // 1. scores: a warp per patch row, the row read once for all K beams
  auto finish = [&](float (&acc)[K], int lr) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float e = warp_sum(acc[k]);
      if (lane == 0) s_e[k * Lc + lr] = e;
    }
  };
  if constexpr (MODE == F_BULK) {
    if (D <= NV * 32 * VEC) {
      // each warp keeps its next P rows in flight: the loads of row
      // lr + P*NW are issued as soon as row lr is scored, into its registers
      for (int lr0 = warp; lr0 < nl; lr0 += P * NW) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int lr = lr0 + p * NW;
          if (lr >= nl) break;
          float acc[K];
#pragma unroll
          for (int k = 0; k < K; ++k) acc[k] = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int d0 = (i * 32 + lane) * VEC;
            if (d0 < D) score_vec<T, K>(acc, buf[p][i], s_hp, s_w, d0, D);
          }
          if (lr + P * NW < nl) load_row<T>(buf[p], ce + (row0 + lr + P * NW) * D, 0, lane, D);
          finish(acc, lr);
        }
      }
    } else {
      // longer rows: NV vectors per lane at a time
      for (int lr = warp; lr < nl; lr += NW) {
        float acc[K];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = 0.f;
        for (int base = 0; base < D; base += NV * 32 * VEC) {
          uint4 raw[NV];
          load_row<T>(raw, ce + (row0 + lr) * D, base, lane, D);
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int d0 = base + (i * 32 + lane) * VEC;
            if (d0 < D) score_vec<T, K>(acc, raw[i], s_hp, s_w, d0, D);
          }
        }
        finish(acc, lr);
      }
    }
  } else {
    for (int lr = warp; lr < nl; lr += NW) {
      float acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0.f;
      const T* row = ce + (row0 + lr) * D;
      for (int d = lane; d < D; d += 32) {
        const float cv = to_f(row[d]);
        const float wv = s_w[d];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] += fast_tanh<T>(cv + s_hp[k * D + d]) * wv;
      }
      finish(acc, lr);
    }
  }
  __syncthreads();

  // 2. softmax over L: the block's max and sum of exp per beam ...
  if (warp < K) {
    const float* e = s_e + warp * Lc;
    float m = -INFINITY;
    for (int l = lane; l < nl; l += 32) m = fmaxf(m, e[l]);
    m = warp_max(m);
    float s = 0.f;
    for (int l = lane; l < nl; l += 32) s += expf(e[l] - m);
    s = warp_sum(s);
    if (lane == 0) {
      s_stat[warp] = m;
      s_stat[K + warp] = s;
    }
  }
  cluster.sync();
  // ... combined over the cluster's blocks, then alpha for this block's rows
  if (warp < K) {
    const int k = warp;
    float m = -INFINITY;
    for (int q = 0; q < C; ++q) m = fmaxf(m, cluster.map_shared_rank(s_stat, q)[k]);
    float s = 0.f;
    for (int q = 0; q < C; ++q) {
      const float* st = cluster.map_shared_rank(s_stat, q);
      if (st[K + k] > 0.f) s += st[K + k] * expf(st[k] - m);
    }
    float* e = s_e + k * Lc;
    float* a_out = alpha + ((size_t)b * K + k) * L + l0;
    for (int l = lane; l < nl; l += 32) {
      const float a = expf(e[l] - m) / s;
      a_out[l] = a;
      e[l] = to_f(from_f<T>(a));
    }
  }
  __syncthreads();

  // 3. the block's partial contexts over its rows, all K in fp32
  if constexpr (MODE == F_BULK) {
    mbar_wait(smem_u32(fbar), 0);
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
  } else {
    for (int d = tid; d < D; d += NT) {
      float acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0.f;
      for (int l = 0; l < nl; ++l) {
        const float fv = to_f(f[(row0 + l) * D + d]);
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = fmaf(s_e[k * Lc + l], fv, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) s_part[k * D + d] = acc[k];
    }
  }
  cluster.sync();

  // 4. block r sums the C partials of its slice of D
  const int Dc = (D + C - 1) / C;
  const int d0 = r * Dc, nd = max(0, min(D, d0 + Dc) - d0);
  const float inv_l = 1.f / (float)L;
  for (int i = tid; i < K * nd; i += NT) {
    const int k = i / nd, d = d0 + i % nd;
    float s = 0.f;
    for (int q = 0; q < C; ++q) s += cluster.map_shared_rank(s_part, q)[k * D + d];
    ctx[((size_t)b * K + k) * D + d] = from_f<T>(s * inv_l);
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

template <typename T, int K, int MODE>
cudaError_t launch_k(const void* ce, const void* f, const void* hp, const void* watt, void* ctx,
                     float* alpha, int B, int L, int D, int C, cudaStream_t s) {
  const int Lc = (L + C - 1) / C;
  const size_t smem = smem_bytes(K, Lc, D, sizeof(T), MODE);
  auto kern = decode_attention_kernel<T, K, MODE>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(ce), static_cast<const T*>(f),
                         static_cast<const T*>(hp), static_cast<const T*>(watt), static_cast<T*>(ctx),
                         alpha, L, D);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch(const void* ce, const void* f, const void* hp, const void* watt, void* ctx,
                   float* alpha, int B, int K, int L, int D, int C, cudaStream_t s) {
  switch (K) {
#define SAT_CASE(KK) \
  case KK:           \
    return launch_k<T, KK, MODE>(ce, f, hp, watt, ctx, alpha, B, L, D, C, s);
    SAT_CASE(1) SAT_CASE(2) SAT_CASE(3) SAT_CASE(4)
    SAT_CASE(5) SAT_CASE(6) SAT_CASE(7) SAT_CASE(8)
#undef SAT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_mode(const void* ce, const void* f, const void* hp, const void* watt, void* ctx,
                        float* alpha, int B, int K, int L, int D, int C, int mode, cudaStream_t s) {
  switch (mode) {
    case DIRECT: return launch<T, DIRECT>(ce, f, hp, watt, ctx, alpha, B, K, L, D, C, s);
    case F_BULK: return launch<T, F_BULK>(ce, f, hp, watt, ctx, alpha, B, K, L, D, C, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int sat_attention_kmax() { return KMAX; }

// dtype: 0 = float32, 1 = bfloat16. cluster: blocks per image, 1..8. mode:
// 0 = DIRECT, 1 = F_BULK (see `Mode`; F_BULK needs D * sizeof(T) a multiple
// of 16, ce, f, hp and w_att 16-byte aligned, and a block's f rows within
// shared memory). Returns a cudaError_t.
extern "C" int sat_decode_attention(const void* ce, const void* f, const void* hp,
                                    const void* watt, void* ctx, float* alpha, int B, int K, int L,
                                    int D, int dtype, int cluster, int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || D <= 0 || K < 1 || K > KMAX || cluster < 1 || cluster > CMAX)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_mode<float>(ce, f, hp, watt, ctx, alpha, B, K, L, D, cluster, mode, s);
  if (dtype == 1)
    return (int)launch_mode<__nv_bfloat16>(ce, f, hp, watt, ctx, alpha, B, K, L, D, cluster, mode, s);
  return (int)cudaErrorInvalidValue;
}
