// Device functions shared by the streaming kernels of this directory
// (tanh_probe.cu; the one-pass kernel of additive_attention.cu, which also
// runs the (image, beam) grid; the row-streaming scores kernel and the
// cluster kernel of the transposed form in beam_attention.cu), for Hopper
// (sm_90a).
//
// The kernels that predate this header (the `direct` designs of the per-row
// attention, of the scores, of the (image, beam) grid and of the transposed
// form, and the cluster kernel of decode_attention.cu) keep their own copies
// of what they use, so that the code they compile to stays as it was
// measured.
//
// Most of what follows works on a lane's 16-byte vector of a patch row: VEC
// = 8 bf16 or 4 fp32 elements. The tanh forms:
//   - bf16: ce + hp and its tanh two at a time in bf16 (`add.bf16x2`,
//     `tanh.approx.bf16x2`, which runs as one special-function operation
//     per half), rounded where the plain versions round them;
//   - fp32: 1 - 2 / (1 + 2^(2x log2 e)) from `ex2.approx` and `rcp.approx`
//     (two special-function operations, absolute error below 5e-7), since
//     `tanh.approx.f32` (~2^-11 relative error) fails the fp32 tolerance.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace sat {

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

// fp32: 1 - 2 / (1 + e^(2x)), from ex2.approx and rcp.approx
__device__ __forceinline__ float tanh_ex2(float x) {
  float t, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(x * 2.8853900817779268f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + t));
  return fmaf(-2.f, r, 1.f);
}

__device__ __forceinline__ float tanh_approx_f32(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh of two packed bf16 (two MUFU.TANH.BF16, one per half)
__device__ __forceinline__ __nv_bfloat162 tanh_bf16x2(__nv_bfloat162 x) {
  uint32_t y;
  asm("tanh.approx.bf16x2 %0, %1;" : "=r"(y) : "r"(*reinterpret_cast<const uint32_t*>(&x)));
  return *reinterpret_cast<const __nv_bfloat162*>(&y);
}

// The VEC elements of the vector `raw` as fp32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(p[i]);
      out[2 * i] = v.x;
      out[2 * i + 1] = v.y;
    }
  } else {
    const float* p = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = p[i];
  }
}

// sum over the VEC elements of tanh(ce + hp) * w: `ce` and `hp` are a
// lane's vectors of the patch row and of the hidden projection, `w` the
// matching elements of w_att as fp32. Products and the sum are fp32.
template <typename T>
__device__ __forceinline__ float score_vec(const uint4& ce, const uint4& hp,
                                           const float (&w)[16 / sizeof(T)]) {
  float acc = 0.f;
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&ce);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hp);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 t = __bfloat1622float2(tanh_bf16x2(__hadd2(c2[p], h2[p])));
      acc = fmaf(t.x, w[2 * p], acc);
      acc = fmaf(t.y, w[2 * p + 1], acc);
    }
  } else {
    const float* c = reinterpret_cast<const float*>(&ce);
    const float* h = reinterpret_cast<const float*>(&hp);
#pragma unroll
    for (int p = 0; p < 4; ++p) acc = fmaf(tanh_ex2(c[p] + h[p]), w[p], acc);
  }
  return acc;
}

// Rows in flight. A warp that loads a row into registers and then works on
// it has one or two rows (1-2 KB) outstanding, and at the ~1.5 us a load
// takes while the card streams, 24 such warps per SM ask for half the bytes
// the memory can deliver. So a warp keeps a ring of rows in shared memory,
// filled by `cp.async` (16 bytes per lane per vector, past L1): the depth of
// the ring, not the register file, sets the bytes in flight. A lane reads
// back only the vectors it copied itself, so `cp.async.wait_group` alone
// orders the copy before the read, with no barrier between lanes.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of a lane's share of `row` into its slots of a ring stage:
// `slots` points at this lane's first slot, vector i goes to slots[i * 32].
template <typename T, int NV>
__device__ __forceinline__ void copy_row(uint4* slots, const T* row, int lane, int D) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d0 = (i * 32 + lane) * VEC;
    if (d0 < D) cp_async16(slots + i * 32, row + d0);
  }
}

// 8 bytes, through L1 (`.cg` takes only 16): the transposed form's ce^T rows
// of L = 196 bf16 are 392 bytes, a multiple of 8 and not of 16.
__device__ __forceinline__ void cp_async8(void* smem_dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: an mbarrier for one arrival, made visible to the async proxy
// (the other threads wait on it only after a barrier of the block).
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on `bar` expecting `bytes` of bulk copies in this phase.
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Copy `bytes` from global `src` to shared `dst` by one bulk asynchronous
// copy that completes on `bar` (both 16-byte aligned, bytes a multiple of
// 16; nothing for 0 bytes). The bytes are announced by `expect_bytes` first.
__device__ __forceinline__ void bulk_copy(uint32_t bar, void* dst, const void* src, uint32_t bytes) {
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// Wait for phase `parity` of `bar`. A copy that never lands traps (a launch
// error) after ~2^34 cycles instead of holding the card.
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
    if (!done) {
      if (t0 == 0) t0 = clock64();
      else if (clock64() - t0 > (1LL << 34)) __trap();
    }
  } while (!done);
}

// A lane's vectors of a ring stage (those past the end of the row hold
// whatever the ring held).
template <int NV>
__device__ __forceinline__ void read_row(uint4 (&r)[NV], const uint4* slots) {
#pragma unroll
  for (int i = 0; i < NV; ++i) r[i] = slots[i * 32];
}

// A lane's share of a row of D elements: NV vectors, vector i at element
// (i * 32 + lane) * VEC, so that a warp's loads are consecutive 512-byte
// runs. Vectors past the end of the row are left as they were.
template <typename T, int NV>
__device__ __forceinline__ void load_row(uint4 (&r)[NV], const T* row, int lane, int D) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d0 = (i * 32 + lane) * VEC;
    if (d0 < D) r[i] = *reinterpret_cast<const uint4*>(row + d0);
  }
}

}  // namespace sat
