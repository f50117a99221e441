// Fused 4-gate LSTM cell for Hopper (sm_90a).
//
// Replaces: show_and_tell_tpu/ops/lstm.py `_cell_kernel` (launched by
// `_lstm_cell_pallas_impl`).
//
// Computes, with torch gate order i, f, g, o and one fused bias:
//     z  = [x, h] @ W + b          W: [I+H, 4H], fp32 accumulation
//     c' = sigmoid(z_f) * c + sigmoid(z_i) * tanh(z_g)
//     h' = sigmoid(z_o) * tanh(c')
// x, h, W are fp32 or bf16 (one type); b, c and c' are fp32; h' has h's type.
//
// Bound on an H100 at the serving shape (B=768 beam rows, I=H=1024, bf16):
// 12.9 GFLOP of matrix product, 13 us at the 989 TFLOP/s bf16 tensor-core
// peak, against ~28 MB moved (W alone is 16.8 MB), ~8 us at 3.35 TB/s. So
// it is bound by operations at beam widths and by bytes at greedy widths
// (B=256: ~6 us).
//
// Design: one block owns BM batch rows and the same BN hidden columns of all
// four gates (W column offsets 0, H, 2H, 3H), so the gate math runs in the
// epilogue and z never reaches device memory. x and h are read through two
// pointers, so no concatenated [x, h] is materialised. The product is a
// shared-memory tiled GEMM: bf16 runs on the tensor cores through WMMA
// (16x16x16, fp32 accumulators), fp32 on the CUDA cores (4x8 outputs per
// thread). The k-loop is a 3-stage ring of shared memory: when I, H and the
// pointers allow 16-byte vectors, tiles arrive by `cp.async` two k-steps
// ahead of the math, so the loads' latency hides behind the tensor cores;
// otherwise (unaligned shapes) they are loaded element by element. Ragged
// edges in B, I+H and H are zero-filled on load and masked on store, so any
// shape runs. wgmma, TMA and a persistent schedule are the levers for a
// later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

constexpr int BM = 64;      // batch rows per block
constexpr int BN = 32;      // hidden columns per gate per block
constexpr int BK = 32;      // depth of one k-tile
constexpr int NC = 4 * BN;  // gate-concatenated columns of one tile
constexpr int NT = 256;     // threads per block (8 warps)
constexpr int STAGES = 3;   // k-tiles in flight

template <typename T>
struct Tile {
  static constexpr int EV = 16 / (int)sizeof(T);  // elements per 16-byte vector
  static constexpr int LDA = BK + 8;              // padded leading dims (elements),
  static constexpr int LDB = NC + 8;              // rows stay 16-byte aligned
  static constexpr int LDC = NC + 4;              // fp32 accumulator tile
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = BM * LDA + BK * LDB;
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(T);
  static constexpr int C_BYTES = BM * LDC * (int)sizeof(float);
  static constexpr int BYTES = RING_BYTES > C_BYTES ? RING_BYTES : C_BYTES;
};

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

template <typename T>
__device__ __forceinline__ T zero() { return from_f<T>(0.f); }

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

// 16-byte global -> shared copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Load k-tile k0 of [x, h] (rows m0..m0+BM) and of the four gates' columns of
// W into one stage of the ring.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(T* As, T* Bs, const T* __restrict__ x,
                                          const T* __restrict__ h, const T* __restrict__ w,
                                          int m0, int n0, int k0, int B, int I, int H) {
  using Tl = Tile<T>;
  const int tid = threadIdx.x;
  const int K = I + H;
  const size_t ldw = 4 * (size_t)H;
  if constexpr (VEC) {
    constexpr int EV = Tl::EV;
    // I % EV == 0 and H % EV == 0: a vector never straddles x|h, K or H
    for (int idx = tid; idx < BM * (BK / EV); idx += NT) {
      const int r = idx / (BK / EV), kk = (idx % (BK / EV)) * EV;
      const int m = m0 + r, k = k0 + kk;
      const T* src = x;
      int bytes = 0;
      if (m < B && k < K) {
        src = k < I ? x + (size_t)m * I + k : h + (size_t)m * H + (k - I);
        bytes = 16;
      }
      cp_async16(As + r * Tl::LDA + kk, src, bytes);
    }
    for (int idx = tid; idx < BK * (NC / EV); idx += NT) {
      const int kk = idx / (NC / EV), cc = (idx % (NC / EV)) * EV;
      const int g = cc / BN, n = n0 + cc % BN;
      const int k = k0 + kk;
      const T* src = w;
      int bytes = 0;
      if (k < K && n < H) {
        src = w + (size_t)k * ldw + (size_t)g * H + n;
        bytes = 16;
      }
      cp_async16(Bs + kk * Tl::LDB + cc, src, bytes);
    }
  } else {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, kk = idx % BK;
      const int m = m0 + r, k = k0 + kk;
      T v = zero<T>();
      if (m < B) {
        if (k < I) v = x[(size_t)m * I + k];
        else if (k < K) v = h[(size_t)m * H + (k - I)];
      }
      As[r * Tl::LDA + kk] = v;
    }
    for (int idx = tid; idx < BK * NC; idx += NT) {
      const int kk = idx / NC, cc = idx % NC;
      const int g = cc / BN, n = n0 + cc % BN;
      const int k = k0 + kk;
      T v = zero<T>();
      if (k < K && n < H) v = w[(size_t)k * ldw + (size_t)g * H + n];
      Bs[kk * Tl::LDB + cc] = v;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h,
                 const T* __restrict__ w, const float* __restrict__ b,
                 const float* __restrict__ c, T* __restrict__ h_out,
                 float* __restrict__ c_out, int B, int I, int H) {
  using Tl = Tile<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);         // STAGES x {A [BM][LDA], B [BK][LDB]}
  float* Cs = reinterpret_cast<float*>(smem);   // [BM][LDC], after the loop

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KT = (I + H + BK - 1) / BK;

  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  // bf16: warp (wm, wg) computes rows wm*32..+32 of gate wg as 2x2 fragments
  const int warp = tid >> 5;
  const int wm = warp >> 2, wg = warp & 3;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc_tc[2][2];
  // fp32: thread (tr, tc) computes rows tr*4..+4, columns tc + 16*j
  const int tr = tid >> 4, tc = tid & 15;
  float acc[4][8];
  if constexpr (kTensorCores) {
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc_tc[i][j], 0.f);
  } else {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  auto stage_a = [&](int s) { return ring + s * Tl::STAGE_ELEMS; };
  auto stage_b = [&](int s) { return ring + s * Tl::STAGE_ELEMS + Tl::A_ELEMS; };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile<T, VEC>(stage_a(s), stage_b(s), x, h, w, m0, n0, s * BK, B, I, H);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();              // ... every thread's part; stage kt-1 is free
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_tile<T, VEC>(stage_a(nk % STAGES), stage_b(nk % STAGES), x, h, w, m0, n0, nk * BK, B,
                        I, H);
    cp_async_commit();

    const T* As = stage_a(kt % STAGES);
    const T* Bs = stage_b(kt % STAGES);
    if constexpr (kTensorCores) {
      using namespace nvcuda;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * Tl::LDA + kk, Tl::LDA);
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * Tl::LDB + wg * BN + j * 16, Tl::LDB);
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc_tc[i][j], fa[i], fb[j], acc_tc[i][j]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], bv[8];
        for (int i = 0; i < 4; ++i) a[i] = to_f(As[(tr * 4 + i) * Tl::LDA + kk]);
        for (int j = 0; j < 8; ++j) bv[j] = to_f(Bs[kk * Tl::LDB + tc + 16 * j]);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead: reuse its shared memory for the z tile

  if constexpr (kTensorCores) {
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * Tl::LDC + wg * BN + j * 16,
                                        acc_tc[i][j], Tl::LDC, nvcuda::wmma::mem_row_major);
  } else {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 8; ++j) Cs[(tr * 4 + i) * Tl::LDC + tc + 16 * j] = acc[i][j];
  }
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int r = idx / BN, j = idx % BN;
    const int m = m0 + r, n = n0 + j;
    if (m >= B || n >= H) continue;
    const float* z = Cs + r * Tl::LDC + j;
    const float gi = sigmoid(z[0 * BN] + b[0 * H + n]);
    const float gf = sigmoid(z[1 * BN] + b[1 * H + n]);
    const float gg = tanhf(z[2 * BN] + b[2 * H + n]);
    const float go = sigmoid(z[3 * BN] + b[3 * H + n]);
    const size_t o = (size_t)m * H + n;
    const float cn = gf * c[o] + gi * gg;
    c_out[o] = cn;
    h_out[o] = from_f<T>(go * tanhf(cn));
  }
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* h, const void* w, const float* b, const float* c,
                   void* h_out, float* c_out, int B, int I, int H, cudaStream_t stream) {
  auto kern = lstm_cell_kernel<T, VEC>;
  constexpr int smem = Tile<T>::BYTES;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((H + BN - 1) / BN, (B + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(h),
                                   static_cast<const T*>(w), b, c, static_cast<T*>(h_out),
                                   c_out, B, I, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const void* x, const void* h, const void* w, const float* b, const float* c,
                       void* h_out, float* c_out, int B, int I, int H, int vec,
                       cudaStream_t s) {
  return vec ? launch<T, true>(x, h, w, b, c, h_out, c_out, B, I, H, s)
             : launch<T, false>(x, h, w, b, c, h_out, c_out, B, I, H, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, h, w and h_out). vec: 1 when I and H
// are multiples of the 16-byte vector width and x, h, w are 16-byte aligned.
// Returns a cudaError_t.
extern "C" int sat_lstm_cell(const void* x, const void* h, const void* w, const float* b,
                             const float* c, void* h_out, float* c_out, int B, int I, int H,
                             int dtype, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || I < 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_any<float>(x, h, w, b, c, h_out, c_out, B, I, H, vec, s);
  if (dtype == 1)
    return (int)launch_any<__nv_bfloat16>(x, h, w, b, c, h_out, c_out, B, I, H, vec, s);
  return (int)cudaErrorInvalidValue;
}
