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
// Two designs, chosen by the wrapper (ops/lstm.py `cell_design`) from the
// shape, the type and the alignment before the launch. Both give one block
// BM batch rows and the same BN hidden columns of all four gates (W column
// offsets 0, H, 2H, 3H), so the gate math runs on the block's own z tile
// and z never reaches device memory; x and h are read apart, so no
// concatenated [x, h] is materialised.
//
// `sat_lstm_cell_sm90` (bf16, I and H multiples of 8, 16-byte aligned
// operands: the serving and training shapes) is built for Hopper:
//   - Tile: BM = 64, 128 or 192 rows (one to three consumer warpgroups of
//     64 rows each) by BN = 32 columns of each gate, so one `wgmma`
//     m64n128k16 covers all four gates. In its accumulator layout a thread
//     holds columns 8j + 2(lane%4) + {0,1} of every 8-column group, so the
//     thread that holds z_i[m, n] also holds z_f, z_g and z_o[m, n]: the gate
//     math and the stores of h' and c' run in registers.
//   - Loads: one producer warp keeps a ring of 4-6 stages in flight by TMA,
//     completion counted on an mbarrier per stage, a second mbarrier per
//     stage handing it back. A stage is one 64-deep k-tile of [x | h]
//     (BM x 64, 128-byte swizzle, K-major) and four boxes of W (64 x 32 per
//     gate, 64-byte swizzle, N-major, read by `wgmma` transposed). The
//     k-loop runs over x's tiles, then h's, with W's row coordinate offset
//     by I for the second: a tile never straddles x and h, for any I.
//     TMA's out-of-bounds fill zeroes the ragged edges in B, K and H, and
//     the stores mask them.
//   - The consumers keep one `wgmma` group in flight while the next
//     k-tile's is issued, and hand a stage back when its group has retired.
//   - The tensor maps are encoded per call from the pointers, through
//     cuTensorMapEncodeTiled reached by cudaGetDriverEntryPoint (no -lcuda),
//     and passed as __grid_constant__ parameters.
//
// `sat_lstm_cell` (fp32, and bf16 shapes TMA cannot take) is a shared-memory
// tiled GEMM: bf16 runs on the tensor cores through WMMA (16x16x16, fp32
// accumulators), fp32 on the CUDA cores (4x8 outputs per thread). The
// k-loop is a 3-stage ring of shared memory: when I, H and the pointers
// allow 16-byte vectors, tiles arrive by `cp.async` two k-steps ahead of the
// math; otherwise (unaligned shapes) they are loaded element by element.
// Ragged edges in B, I+H and H are zero-filled on load and masked on store,
// so any shape runs.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

namespace sm90 {

constexpr int BK = 64;                // k per stage: 128 bytes of bf16, one swizzle row of A
constexpr int BN = 32;                // hidden columns per gate: 64 bytes, one swizzle row of W
constexpr int A_ROW = BK * 2;         // bytes of one row of an A tile
constexpr int B_GATE = BK * BN * 2;   // bytes of one gate's W box
constexpr int B_BYTES = 4 * B_GATE;   // the four gates of one stage

template <int WG>  // consumer warpgroups
struct Cfg {
  static constexpr int BM = 64 * WG;
  static constexpr int A_BYTES = BM * A_ROW;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = WG == 1 ? 6 : (WG == 2 ? 5 : 4);
  static constexpr int NT = WG * 128 + 32;  // the consumers, then one producer warp
  // 1 KB of slack to align the ring for the swizzle, then the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

// d += A (64x16, K-major) * B (16x128, N-major: transposed), bf16 in, fp32 sum
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int WG>
__global__ void __launch_bounds__(Cfg<WG>::NT)
lstm_cell_sm90_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap th,
                      const __grid_constant__ CUtensorMap tw, const float* __restrict__ b,
                      const float* __restrict__ c, __nv_bfloat16* __restrict__ h_out,
                      float* __restrict__ c_out, int B, int I, int H) {
  using C = Cfg<WG>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzled tiles want 1 KB alignment
  const uint32_t full = ring + C::STAGES * C::STAGE;
  const uint32_t empty = full + C::STAGES * 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * C::BM;
  const int KX = (I + BK - 1) / BK, KT = KX + (H + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);            // the producer's arrival, plus the bytes
      mbar_init(empty + 8 * s, WG * 4);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WG * 4) {
    // producer: one thread issues every copy
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % C::STAGES;
        if (kt >= C::STAGES) mbar_wait(empty + 8 * s, ((kt / C::STAGES) - 1) & 1);
        const uint32_t a = ring + s * C::STAGE, bt = a + C::A_BYTES, bar = full + 8 * s;
        mbar_expect_tx(bar, C::STAGE);
        int wrow;
        if (kt < KX) {
          tma_load(a, &tx, kt * BK, m0, bar);
          wrow = kt * BK;
        } else {
          tma_load(a, &th, (kt - KX) * BK, m0, bar);
          wrow = I + (kt - KX) * BK;
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) tma_load(bt + g * B_GATE, &tw, g * H + n0, wrow, bar);
      }
    }
  } else {
    // consumers: warpgroup wg computes rows m0 + 64 wg .. + 64 of all four gates
    const int wg = warp >> 2;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % C::STAGES;
      mbar_wait(full + 8 * s, (kt / C::STAGES) & 1);
      const uint32_t a = ring + s * C::STAGE + wg * 64 * A_ROW, bt = ring + s * C::STAGE + C::A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: 128-byte rows, 8-row groups 1 KB apart; a k16 slice is 32 bytes on
        // B: per gate 64-byte k-rows, 8-row groups 512 B apart, gates B_GATE apart;
        //    a k16 slice is 16 rows on
        wgmma_m64n128k16(acc, desc(a + kk * 32, 16, 1024, 1), desc(bt + kk * 16 * 64, B_GATE, 512, 2));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % C::STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    // epilogue in registers: acc[4 (4 g + jj) + 2 r + e] is z_g at row
    // 16 (warp % 4) + lane / 4 + 8 r, column 8 jj + 2 (lane % 4) + e
    const int row0 = m0 + wg * 64 + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + 8 * jj + 2 * (lane & 3);  // even; H % 8 == 0, so n < H covers n + 1
      if (n >= H) continue;
      const float2 bi = *reinterpret_cast<const float2*>(b + 0 * H + n);
      const float2 bf = *reinterpret_cast<const float2*>(b + 1 * H + n);
      const float2 bg = *reinterpret_cast<const float2*>(b + 2 * H + n);
      const float2 bo = *reinterpret_cast<const float2*>(b + 3 * H + n);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = row0 + 8 * r;
        if (m >= B) continue;
        const size_t o = (size_t)m * H + n;
        const float2 cv = *reinterpret_cast<const float2*>(c + o);
        float hn[2], cn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * r + e;
          const float gi = sigmoid(acc[i] + (e ? bi.y : bi.x));
          const float gf = sigmoid(acc[16 + i] + (e ? bf.y : bf.x));
          const float gg = tanhf(acc[32 + i] + (e ? bg.y : bg.x));
          const float go = sigmoid(acc[48 + i] + (e ? bo.y : bo.x));
          cn[e] = gf * (e ? cv.y : cv.x) + gi * gg;
          hn[e] = go * tanhf(cn[e]);
        }
        *reinterpret_cast<float2*>(c_out + o) = make_float2(cn[0], cn[1]);
        *reinterpret_cast<__nv_bfloat162*>(h_out + o) = __floats2bfloat162_rn(hn[0], hn[1]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// A 2-D bf16 row-major [rows, cols] tensor, boxes of box_rows x box_cols.
bool encode(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows,
            uint32_t box_cols, CUtensorMapSwizzle swizzle, CUtensorMapL2promotion promo) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promo,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WG>
cudaError_t launch(const void* x, const void* h, const void* w, const float* b, const float* c,
                   void* h_out, float* c_out, int B, int I, int H, cudaStream_t stream) {
  using C = Cfg<WG>;
  CUtensorMap tx, th, tw;
  if (!encode(&tx, x, B, I, C::BM, BK, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode(&th, h, B, H, C::BM, BK, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode(&tw, w, (uint64_t)I + H, 4 * (uint64_t)H, BK, BN, CU_TENSOR_MAP_SWIZZLE_64B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return cudaErrorInvalidValue;
  auto kern = lstm_cell_sm90_kernel<WG>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((H + BN - 1) / BN, (B + C::BM - 1) / C::BM);
  kern<<<grid, C::NT, C::SMEM, stream>>>(tx, th, tw, b, c, static_cast<__nv_bfloat16*>(h_out), c_out,
                                         B, I, H);
  return cudaGetLastError();
}

}  // namespace sm90

// The Hopper design, bf16 only. I and H multiples of 8; x, h, w, b, c, h_out
// and c_out 16-byte aligned; bm (batch rows per block) 64, 128 or 192.
// Returns a cudaError_t.
extern "C" int sat_lstm_cell_sm90(const void* x, const void* h, const void* w, const float* b,
                                  const float* c, void* h_out, float* c_out, int B, int I, int H,
                                  int bm, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || I <= 0 || H <= 0 || I % 8 || H % 8) return (int)cudaErrorInvalidValue;
  switch (bm) {
    case 64: return (int)sm90::launch<1>(x, h, w, b, c, h_out, c_out, B, I, H, s);
    case 128: return (int)sm90::launch<2>(x, h, w, b, c, h_out, c_out, B, I, H, s);
    case 192: return (int)sm90::launch<3>(x, h, w, b, c, h_out, c_out, B, I, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
