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
// Bounds on an H100 at the serving shape (B=768 beam rows, I=H=1024): 12.9
// GFLOP of matrix product. In bf16 that is 13 us at the 989 TFLOP/s
// tensor-core peak, against ~28 MB moved (W alone is 16.8 MB), ~8 us at
// 3.35 TB/s: bound by operations at beam widths and by bytes at greedy
// widths (B=256: ~6 us). In fp32 the CUDA cores (67 TFLOP/s) need 192 us;
// on the tensor cores three TF32 products (below) need 3 x 12.9 GFLOP at
// 495 TFLOP/s = 78 us (B=256: 26 us), against ~15 us of bytes (W is 33.6 MB).
//
// Five designs, chosen by the wrapper (ops/lstm.py `cell_design`) from the
// shape, the type and the alignment before the launch. Each but `mcast`
// gives one block BM batch rows and the same BN hidden columns of all four
// gates (W column offsets 0, H, 2H, 3H), so the gate math runs on the
// block's own z tile; `mcast` gives each gate a block of a cluster, whose
// z tiles meet in distributed shared memory. z never reaches device memory;
// x and h are read apart, so no concatenated [x, h] is materialised.
//
// `sat_lstm_cell_skinny` (bf16 and fp32, I and H multiples of 8 and 4,
// 16-byte aligned operands, B up to ops/lstm.py `SKINNY_MAX_B`: the serving
// front door's batches) is the cell as a matrix-vector product. There it
// replaces `wgmma` and `tf32x3`, whose 64-row tiles give only H / 32 = 32
// blocks on 132 SMs at B <= 64, B of each tile's 64 rows real. At B=1,
// I=H=1024 the cell moves
// ~16.8 MB (bf16; fp32 ~33.6 MB), almost all of it W: 5.0 us (10.0 us) at
// 3.35 TB/s, against 16.8 MFLOP; at B=32 5.1 us (10.2 us) against 0.54
// GFLOP, 8 us on the fp32 CUDA cores: bound by bytes. So it reads each byte
// of W once, spread over H / 8 = 128 blocks:
//   - Tile: BN = 8 hidden columns of each gate (32 columns of z) by BT = 8,
//     16, 32 or 64 batch rows (B / 64 row blocks past 64).
//   - Loads: one producer warp streams k-tiles of 128 bytes of [x|h] (BT
//     rows; a tile never straddles x and h) and the same k-rows of the
//     block's columns of W, as it is, by TMA into a ring of 16 stages (8 at
//     BT=64) on mbarriers. bf16 takes W as four 2-D boxes of 64 k-rows by 8
//     columns, one per gate, each 1 KB of 16-byte rows; fp32 one 3-D box over
//     W viewed as [K][4][H], [32 k-rows][4][8], so a k-row is 128
//     consecutive bytes.
//   - Products: eight consumer warps take the k-tiles in turn (warp w tiles
//     w, w + 8, ...), each summing a partial z of BT rows by 32 columns in
//     registers. bf16 runs `mma.sync` m16n8k16 in the swapped form z^T =
//     W^T [x|h]^T, so that B pads to 8 rows: W^T's fragments by
//     `ldmatrix.trans` from W's rows (a gate's 8 k-rows are 128 contiguous
//     bytes: no bank conflict), [x|h]'s by `ldmatrix` from its 128-byte
//     swizzled tile. fp32 runs `fmaf` on the CUDA cores, W as it is (no
//     split, no W^T): lane l owns column l, [x|h] is read as broadcasts.
//   - The warps' partials meet in shared memory in warp order, then the
//     gate math; h' and c' are written once, ragged B and H masked.
//   - Its pace is set by the stream of W's 16-byte (bf16) and 32-byte
//     (fp32) pieces per gate, ~1.5 TB/s on the H100, not by the products;
//     past 32 rows the fp32 FMAs also wait on the reads of [x|h] (PERF.md).
//
// `sat_lstm_cell_mcast` (bf16, I and H multiples of 8, 16-byte aligned
// operands, `SKINNY_MAX_B` < B <= `MCAST_MAX_B`, 65-192: beam-3 at the
// serving bucket 32, B=96; greedy at bucket 128 and the training batch,
// B=128; the eval driver's beam, B=192) is the cell between the two
// regimes. There it replaces `wgmma`, whose 64-row tiles give 2 x 32 = 64
// blocks at B = 65-128 and lost to torch.lstm_cell.
// Its bound is the bytes, almost all of them W: 0.0054 ms at B=96, 0.0056
// at 128, 0.0058 at 192 (I=H=1024, 3.35 TB/s).
//   - Tile: a cluster of four blocks, one per gate, over the same 64 batch
//     rows and 64 hidden columns: block g forms z_g = [x|h] W[:, gH + n0 ..
//     + 64) by one `wgmma` m64n64k16 per k16 (W's box N-major, read
//     transposed, 128-byte swizzle). 4 x H / 64 blocks per row block: 128
//     at B = 65-128, H=1024, and 192 at B = 129-192.
//   - Loads: one producer warp per block keeps a ring of 6 stages on
//     mbarriers. A stage is one 64-deep k-tile of [x|h] (64 rows of 128
//     bytes) and the block's box of W (64 k-rows of 128 bytes: a gate's 64
//     columns, where `wgmma` reads 32 columns of each gate, 64-byte rows).
//     The four blocks share the [x|h] tile: each issues 16 of its rows by
//     one TMA multicast to all four and arms its own barrier for the whole
//     stage. A stage is refilled only when all four have read it: each
//     consumer warp hands it back to the barrier of every block of the
//     cluster (lane q arrives at block q through mapa, with the default
//     release at CTA scope: one at cluster scope, one lane arriving after
//     another, made a first development build several times slower).
//   - Gates: after the k-loop each block writes its z tile over its ring,
//     and after a cluster barrier block g finishes hidden columns 16 g ..
//     16 g + 15 of the 64 from the four tiles (float4 reads through
//     distributed shared memory); h' and c' are written once. TMA's fill
//     zeroes the ragged edges in B, K and H, and the stores mask them.
//   - Occupancy: with one block per SM, 30 clusters of four run at once on
//     the H100 (cudaOccupancyMaxActiveClusters) and B = 65-128 needs 32, a
//     second wave; with a 97 KB ring two blocks fit per SM (62 clusters, so
//     three row blocks, 48, still run in one wave and four, 64, do not).
//   - L2 traffic at B=128: W once per row block (2 x 16.8 MB), [x|h] once
//     per cluster (32 x 0.25 MB), ~42 MB, against `wgmma`'s ~50 MB (W twice,
//     [x|h] once per column block, 32 x 0.5 MB). W still leaves L2 twice: a
//     first development build that shared W between the row blocks by
//     multicast too (16 columns of each gate per block, 32-byte rows of W)
//     ran no faster than `wgmma`. The pace follows the box rows that land in
//     each SM's shared memory per stage, 128 here against `wgmma`'s 320 and
//     that build's 320, more than the bytes read from L2 (PERF.md). Its
//     loads alone (`stream_only`) take most of its time.
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
// `sat_lstm_cell_tf32x3` (fp32, I and H multiples of 4, 16-byte aligned
// operands: the `Config` default's serving and training shapes) runs the
// fp32 product on the tensor cores at fp32 accuracy ("3xTF32"): each operand
// a is split into big = rna_tf32(a) and small = rna_tf32(a - big), both
// exact in TF32's 10 mantissa bits, and z = a_s*w_b + a_b*w_s + a_b*w_b
// (small products first; the dropped a_s*w_s is ~2^-22 of a*w), each a
// `wgmma` m64n128k8 of kind TF32 into fp32 accumulators. The rounding is
// explicit (cvt.rna.tf32.f32) because `wgmma` reads a 32-bit container and
// drops its low 13 bits: an unrounded big would leave its truncation error
// out of small.
//   - W: for 32-bit types `wgmma` takes both shared-memory operands K-major,
//     with no transpose, and W [I+H, 4H] is N-major. The wrapper keeps W^T
//     split once per weight version (ops/lstm.py `tf32x3_weight`: [2, 4H,
//     I+H], big then small, 2 x 33.6 MB for the serving W), so each stage
//     loads both parts of four 32 x 32 boxes by TMA and nothing is split
//     per block. The alternative, z^T = W^T [x, h]^T with W^T as A from
//     registers, would meet the four gates on accumulator rows of different
//     warps and need a second trip through shared memory.
//   - [x | h]: a stage's 64 x 32 tile arrives by TMA (128-byte swizzle,
//     K-major); the consumer warpgroup rounds it in place to its big part
//     and writes the small part to a second buffer of the stage at the same
//     offsets (the split is element-wise, so the swizzle needs no
//     decoding), then `fence.proxy.async` and a named barrier of its 128
//     threads before its `wgmma`s read them.
//   - Sums: the tensor cores round each accumulation toward zero, so one
//     running sum over the 3 (I + H) / 8 products drifts (past phase 3's
//     1e-5 at the serving shape). Each 32-deep stage sums its twelve products into
//     a fresh partial; the partials meet in an fp32 total by
//     round-to-nearest adds. Two partials alternate, so that one stage's
//     products run while the last one's partial is added (217 registers).
//   - Tile: BM = 64 (one consumer warpgroup) by BN = 32 columns of each
//     gate: the accumulator layout, the epilogue in registers and the ring
//     on mbarriers are the bf16 design's. A stage is 2 x 8 KB of [x | h]
//     and 2 x 16 KB of W^T: 4 stages (192 KB), one block per SM. Its pace
//     is set by the stream of tiles from L2 through the ring (W^T's two
//     parts are read again by every row block) and, close behind, by the
//     consumer's work per stage, not by the tensor cores: 45 % of the
//     3xTF32 bound at B=768 (PERF.md).
//
// `sat_lstm_cell` (the shapes neither design takes: I or H not a multiple
// of 8 in bf16 or of 4 in fp32, a misaligned operand) is a shared-memory
// tiled GEMM: bf16 runs on the tensor cores through WMMA (16x16x16, fp32
// accumulators), fp32 on the CUDA cores (4x8 outputs per thread). The
// k-loop is a 3-stage ring of shared memory: when I, H and the pointers
// allow 16-byte vectors, tiles arrive by `cp.async` two k-steps ahead of the
// math; otherwise (unaligned shapes) they are loaded element by element.
// Ragged edges in B, I+H and H are zero-filled on load and masked on store,
// so any shape runs. Before the 3xTF32 design it ran every fp32 cell.

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
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// A 2-D row-major [rows, cols] tensor of bf16 (or, with f32, fp32), boxes
// of box_rows x box_cols.
bool encode(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows,
            uint32_t box_cols, CUtensorMapSwizzle swizzle, CUtensorMapL2promotion promo,
            bool f32 = false) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (f32 ? sizeof(float) : sizeof(__nv_bfloat16))};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            promo, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// --- 3xTF32: the fp32 cell on the tensor cores ------------------------------

// in a namespace of its own, so that its constants hide the bf16 design's
namespace t3 {

constexpr int BM = 64;                // batch rows per block: one consumer warpgroup
constexpr int BK = 32;                // k per stage: 128 bytes of fp32, one swizzle row
constexpr int BN = 32;                // hidden columns per gate per block
constexpr int ROW = BK * 4;           // bytes of one k-row of a tile ([x|h] row, W^T row)
constexpr int A_BYTES = BM * ROW;     // one stage's [x|h] tile
constexpr int W_GATE = BN * ROW;      // one gate's box of W^T: 32 rows of 128 bytes
constexpr int W_BYTES = 4 * W_GATE;   // the four gates: 128 rows, one wgmma's N
// [x|h] rounded in place to its big part, its small part, W^T big, W^T small
constexpr int STAGE = 2 * A_BYTES + 2 * W_BYTES;
constexpr int STAGES = 4;
constexpr int NT = 128 + 32;          // the consumer warpgroup, then one producer warp
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;

// a rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// d = A (64x8, K-major) * B (8x128, K-major) + (accumulate ? d : 0), TF32
// in, fp32 sum
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64], uint64_t da, uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// Stage kt of the consumer warpgroup (thread t of 128): wait for its tiles,
// split [x|h] into its TF32 parts, and issue the stage's twelve products
// into acc, a fresh partial sum (one commit group).
__device__ __forceinline__ void tf32x3_stage(float (&acc)[64], int kt, uint32_t ring,
                                             unsigned char* ring_p, uint32_t full, int t) {
  const int s = kt % STAGES;
  mbar_wait(full + 8 * s, (kt / STAGES) & 1);
  const uint32_t ab = ring + s * STAGE, as = ab + A_BYTES, wb = as + A_BYTES, ws = wb + W_BYTES;
  // the split: 64 rows x 128 bytes = 512 float4, 4 per thread; element-wise,
  // so the small part lands at the big part's (swizzled) offsets
  float4* const pb = reinterpret_cast<float4*>(ring_p + (ab - ring));
  float4* const ps = reinterpret_cast<float4*>(ring_p + (as - ring));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = t + 128 * i;
    const float4 v = pb[j];
    const float4 big = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
    pb[j] = big;
    ps[j] = make_float4(tf32_rna(v.x - big.x), tf32_rna(v.y - big.y), tf32_rna(v.z - big.z),
                        tf32_rna(v.w - big.w));
  }
  // this thread's generic-proxy writes before the async proxy's reads, then
  // every thread of the warpgroup
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    // every tile: 128-byte rows, 8-row groups 1 KB apart; a k8 slice is 32 bytes on
    const uint64_t dab = desc(ab + kk * 32, 16, 1024, 1), das = desc(as + kk * 32, 16, 1024, 1);
    const uint64_t dwb = desc(wb + kk * 32, 16, 1024, 1), dws = desc(ws + kk * 32, 16, 1024, 1);
    wgmma_tf32_m64n128k8(acc, das, dwb, kk > 0);
    wgmma_tf32_m64n128k8(acc, dab, dws, 1);
    wgmma_tf32_m64n128k8(acc, dab, dwb, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_acc(acc);
}

// After stage kt's products were issued: wait for stage kt - 1's, add its
// partial sum into the total (round to nearest) and hand its tiles back.
__device__ __forceinline__ void tf32x3_retire(float (&total)[64], float (&prev)[64], int kt,
                                              uint32_t empty, int lane) {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  fence_acc(prev);
  if (kt > 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] += prev[i];
    if (lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
}

__global__ void __launch_bounds__(t3::NT)
lstm_cell_tf32x3_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap th,
                        const __grid_constant__ CUtensorMap tw, const float* __restrict__ b,
                        const float* __restrict__ c, float* __restrict__ h_out,
                        float* __restrict__ c_out, int B, int I, int H) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzled tiles want 1 KB alignment
  unsigned char* const ring_p = smem_raw + (ring - raw);
  const uint32_t full = ring + STAGES * STAGE;
  const uint32_t empty = full + STAGES * 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int KX = (I + BK - 1) / BK, KT = KX + (H + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrival, plus the bytes
      mbar_init(empty + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: one thread issues every copy; W^T's small part is 4H rows on
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, ((kt / STAGES) - 1) & 1);
        const uint32_t a = ring + s * STAGE, wb = a + 2 * A_BYTES, bar = full + 8 * s;
        mbar_expect_tx(bar, A_BYTES + 2 * W_BYTES);
        int k;
        if (kt < KX) {
          tma_load(a, &tx, kt * BK, m0, bar);
          k = kt * BK;
        } else {
          tma_load(a, &th, (kt - KX) * BK, m0, bar);
          k = I + (kt - KX) * BK;
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          tma_load(wb + g * W_GATE, &tw, k, g * H + n0, bar);
          tma_load(wb + W_BYTES + g * W_GATE, &tw, k, 4 * H + g * H + n0, bar);
        }
      }
    }
  } else {
    // the consumer warpgroup: rows m0 .. m0 + 64 of all four gates. The
    // tensor cores round each accumulation toward zero, so a running sum
    // over all 3 (I + H) / 8 products would drift by up to an ulp of z per
    // product: each stage sums into a fresh partial (twelve products), and
    // the partials meet in `total` by round-to-nearest adds. Two partials
    // alternate, so that one stage's products run while the last one's
    // partial is added.
    float total[64], acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = acc0[i] = acc1[i] = 0.f;
    for (int kt = 0; kt < KT; kt += 2) {
      tf32x3_stage(acc0, kt, ring, ring_p, full, tid);
      tf32x3_retire(total, acc1, kt, empty, lane);
      if (kt + 1 < KT) {
        tf32x3_stage(acc1, kt + 1, ring, ring_p, full, tid);
        tf32x3_retire(total, acc0, kt + 1, empty, lane);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc0);
    fence_acc(acc1);
    if (KT & 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += acc0[i];
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += acc1[i];
    }

    // epilogue in registers, as the bf16 design's: total[4 (4 g + jj) + 2 r + e]
    // is z_g at row 16 warp + lane / 4 + 8 r, column 8 jj + 2 (lane % 4) + e
    const int row0 = m0 + 16 * warp + (lane >> 2);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + 8 * jj + 2 * (lane & 3);  // even; H % 4 == 0, so n < H covers n + 1
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
          const float gi = sigmoid(total[i] + (e ? bi.y : bi.x));
          const float gf = sigmoid(total[16 + i] + (e ? bf.y : bf.x));
          const float gg = tanhf(total[32 + i] + (e ? bg.y : bg.x));
          const float go = sigmoid(total[48 + i] + (e ? bo.y : bo.x));
          cn[e] = gf * (e ? cv.y : cv.x) + gi * gg;
          hn[e] = go * tanhf(cn[e]);
        }
        *reinterpret_cast<float2*>(c_out + o) = make_float2(cn[0], cn[1]);
        *reinterpret_cast<float2*>(h_out + o) = make_float2(hn[0], hn[1]);
      }
    }
  }
}

cudaError_t launch_tf32x3(const void* x, const void* h, const void* wt, const float* b, const float* c,
                          void* h_out, float* c_out, int B, int I, int H, cudaStream_t stream) {
  CUtensorMap tx, th, tw;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode(&tx, x, B, I, BM, BK, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, true) ||
      !encode(&th, h, B, H, BM, BK, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, true) ||
      !encode(&tw, wt, 8 * (uint64_t)H, (uint64_t)I + H, BN, BK, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              true))
    return cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(lstm_cell_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((H + BN - 1) / BN, (B + BM - 1) / BM);
  lstm_cell_tf32x3_kernel<<<grid, NT, SMEM, stream>>>(tx, th, tw, b, c, static_cast<float*>(h_out), c_out,
                                                      B, I, H);
  return cudaGetLastError();
}

}  // namespace t3

// --- skinny: the cell at small batch, a matrix-vector product ---------------

namespace sk {

constexpr int BN = 8;              // hidden columns per gate per block: 32 columns of z
constexpr int NW = 8;              // consumer warps: warp w takes k-tiles w, w + NW, ...
constexpr int NT = NW * 32 + 32;   // the consumers, then one producer warp
constexpr int ROW = 128;           // bytes of one k-tile's row of [x|h]: 64 bf16 or 32 fp32

template <typename T, int BT>  // BT: batch rows per block, 8, 16, 32 or 64
struct Cfg {
  static constexpr int BK = ROW / (int)sizeof(T);                 // depth of one k-tile
  static constexpr int X_BYTES = BT * ROW;                        // [x|h]: BT rows of one k-tile
  static constexpr int W_GATE = BK * BN * (int)sizeof(T);         // one gate's slice of W: 1 KB
  static constexpr int STAGE = X_BYTES + 4 * W_GATE;
  // one block per SM up to 32 rows (H / 8 blocks fill the card); two at 64,
  // where B > 64 gives a second row block
  static constexpr int STAGES = BT == 64 ? 8 : 16;
  static constexpr int RED_BYTES = NW * BT * 4 * BN * 4;           // the warps' partial z, fp32
  static constexpr int REGION = STAGES * STAGE > RED_BYTES ? STAGES * STAGE : RED_BYTES;
  static constexpr int SMEM = 1024 + REGION + 2 * STAGES * 8;
};

__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += A (16x16, row) * B (16x8, col), bf16 in, fp32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's products of one k-tile, fp32 on the FMA pipe. Lane l is column
// l of the block's z (gate l / 8, hidden n0 + l % 8); acc[r] is batch row r.
// xs: [BT][32] fp32; ws: [32 k][4 gates][8] fp32, so a k-row is 32 lanes'
// consecutive words. k runs in order, one fmaf per (k, row).
template <int BT>
__device__ __forceinline__ void tile_fma(float (&acc)[BT], const unsigned char* stage, int lane) {
  const float* xs = reinterpret_cast<const float*>(stage);
  const float* ws = reinterpret_cast<const float*>(stage + BT * ROW);
#pragma unroll
  for (int k4 = 0; k4 < 8; ++k4) {
    float wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[q] = ws[(4 * k4 + q) * 32 + lane];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + r * 32 + 4 * k4);  // one address: a broadcast
      acc[r] = fmaf(xv.x, wv[0], acc[r]);
      acc[r] = fmaf(xv.y, wv[1], acc[r]);
      acc[r] = fmaf(xv.z, wv[2], acc[r]);
      acc[r] = fmaf(xv.w, wv[3], acc[r]);
    }
  }
}

// One warp's products of one k-tile, bf16 on the tensor cores by mma.sync
// m16n8k16 in the swapped form z^T = W^T [x|h]^T, so that B <= 8 pads to 8
// rows, not 16: A is W^T, 16 columns of z (two gates' 8) by 16 k, read by
// ldmatrix.trans from W's rows; B is [x|h]^T, 16 k by 8 batch rows, read by
// ldmatrix from [x|h]'s rows. acc[t][j] is m-tile t (gates 2t, 2t + 1) by
// n-tile j (batch rows 8j..8j+7): d[0], d[1] z of gate 2t at hidden lane / 4,
// rows 8j + 2 (lane % 4) + {0, 1}; d[2], d[3] the same of gate 2t + 1.
// xs: [BT][64] bf16, 128-byte swizzle (chunk c of row r at c ^ (r % 8));
// ws: [4 gates][64 k][8] bf16, unswizzled (8 k-rows of a gate are 128
// contiguous bytes: no bank conflict).
template <int BT>
__device__ __forceinline__ void tile_mma(float (&acc)[2][BT / 8][4], uint32_t stage, int lane) {
  const uint32_t xs = stage, ws = stage + BT * ROW;
  const int q = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)  // matrices: (gate 2t, k lo), (2t + 1, k lo), (2t, k hi), (2t + 1, k hi)
      ldsm_x4_trans(a[t], ws + ((2 * t + (q & 1)) * 64 + 16 * kk + 8 * (q >> 1) + r8) * 16);
    if constexpr (BT == 8) {
      uint32_t bq[2];  // matrices (rows 0-7, k lo), (rows 0-7, k hi); lanes 16-31 repeat 0-15
      const int chunk = 2 * kk + (q & 1);
      ldsm_x2(bq, xs + r8 * ROW + ((chunk ^ r8) << 4));
#pragma unroll
      for (int t = 0; t < 2; ++t) mma_bf16(acc[t][0], a[t], bq[0], bq[1]);
    } else {
#pragma unroll
      for (int j = 0; j < BT / 8; j += 2) {
        uint32_t bq[4];  // matrices (n-tile j, k lo), (j, k hi), (j + 1, k lo), (j + 1, k hi)
        const int row = 8 * j + 8 * (q >> 1) + r8, chunk = 2 * kk + (q & 1);
        ldsm_x4(bq, xs + row * ROW + ((chunk ^ (row & 7)) << 4));
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_bf16(acc[t][j], a[t], bq[0], bq[1]);
          mma_bf16(acc[t][j + 1], a[t], bq[2], bq[3]);
        }
      }
    }
  }
}

template <typename T, int BT>
__global__ void __launch_bounds__(NT, BT == 64 ? 2 : 1)
lstm_cell_skinny_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap th,
                        const __grid_constant__ CUtensorMap tw, const float* __restrict__ b,
                        const float* __restrict__ c, T* __restrict__ h_out, float* __restrict__ c_out,
                        int B, int I, int H) {
  using C = Cfg<T, BT>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzled [x|h] tiles want 1 KB alignment
  unsigned char* const ring_p = smem_raw + (ring - raw);
  const uint32_t full = ring + C::REGION;
  const uint32_t empty = full + C::STAGES * 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BT;
  const int KX = (I + C::BK - 1) / C::BK, KT = KX + (H + C::BK - 1) / C::BK;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrival, plus the bytes
      mbar_init(empty + 8 * s, 1);  // the one warp that consumes the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NW) {
    // producer: one thread issues every copy. A stage is one k-tile of
    // [x|h] (a tile never straddles x and h: W's row coordinate is offset
    // by I for h's) and the same k rows of the block's 8 columns of each
    // gate. TMA zero-fills past B, I, H and I + H; the stores mask B and H.
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % C::STAGES;
        if (kt >= C::STAGES) mbar_wait(empty + 8 * s, ((kt / C::STAGES) - 1) & 1);
        const uint32_t xs = ring + s * C::STAGE, ws = xs + C::X_BYTES, bar = full + 8 * s;
        mbar_expect_tx(bar, C::STAGE);
        int k;
        if (kt < KX) {
          tma_load(xs, &tx, kt * C::BK, m0, bar);
          k = kt * C::BK;
        } else {
          tma_load(xs, &th, (kt - KX) * C::BK, m0, bar);
          k = I + (kt - KX) * C::BK;
        }
        if constexpr (kF32) {
          tma_load3(ws, &tw, n0, 0, k, bar);  // W as [K][4][H]: one box of [BK][4][8]
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g) tma_load(ws + g * C::W_GATE, &tw, g * H + n0, k, bar);
        }
      }
    }
  } else {
    // consumers: each warp sums its k-tiles into a partial z of the block's
    // BT rows by 32 columns, in registers
    float* const red = reinterpret_cast<float*>(ring_p);  // [NW][BT][4 gates][8], after the loop
    if constexpr (kF32) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.f;
      for (int kt = warp; kt < KT; kt += NW) {
        const int s = kt % C::STAGES;
        mbar_wait(full + 8 * s, (kt / C::STAGES) & 1);
        tile_fma<BT>(acc, ring_p + s * C::STAGE, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(NW * 32) : "memory");  // every stage read: the ring is free
#pragma unroll
      for (int r = 0; r < BT; ++r) red[(warp * BT + r) * 32 + lane] = acc[r];
    } else {
      float acc[2][BT / 8][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
      for (int kt = warp; kt < KT; kt += NW) {
        const int s = kt % C::STAGES;
        mbar_wait(full + 8 * s, (kt / C::STAGES) & 1);
        tile_mma<BT>(acc, ring + s * C::STAGE, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(NW * 32) : "memory");
      const int hid = lane >> 2, col = 2 * (lane & 3);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * j + col + (e & 1), g = 2 * t + (e >> 1);
            red[(warp * BT + r) * 32 + g * BN + hid] = acc[t][j][e];
          }
    }
  }
  __syncthreads();

  // the gates: z = the warps' partials summed in warp order, then the bias
  const float* red = reinterpret_cast<const float*>(ring_p);
  for (int idx = tid; idx < BT * BN; idx += NT) {
    const int r = idx / BN, j = idx % BN;
    const int m = m0 + r, n = n0 + j;
    if (m >= B || n >= H) continue;
    float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g] += red[(w * BT + r) * 32 + g * BN + j];
    const float gi = sigmoid(z[0] + b[0 * H + n]);
    const float gf = sigmoid(z[1] + b[1 * H + n]);
    const float gg = tanhf(z[2] + b[2 * H + n]);
    const float go = sigmoid(z[3] + b[3 * H + n]);
    const size_t o = (size_t)m * H + n;
    const float cn = gf * c[o] + gi * gg;
    c_out[o] = cn;
    h_out[o] = from_f<T>(go * tanhf(cn));
  }
}

// W [K, 4H] fp32 as a 3-D tensor [K][4][H], so that one box of [BK][4][BN]
// holds the block's columns of all four gates, k-row by k-row.
bool encode_w3(CUtensorMap* map, const void* w, uint64_t K, uint64_t H, uint32_t bk) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {H, 4, K};
  const cuuint64_t strides[2] = {H * sizeof(float), 4 * H * sizeof(float)};
  const cuuint32_t box[3] = {BN, 4, bk};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(w), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BT>
cudaError_t launch(const void* x, const void* h, const void* w, const float* b, const float* c, void* h_out,
                   float* c_out, int B, int I, int H, cudaStream_t stream) {
  using C = Cfg<T, BT>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  // fp32 rows of [x|h] are read as broadcasts (every lane one address): no swizzle
  const auto sw = kF32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  const auto promo = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;
  CUtensorMap tx, th, tw;
  if (!encode(&tx, x, B, I, BT, C::BK, sw, promo, kF32) || !encode(&th, h, B, H, BT, C::BK, sw, promo, kF32))
    return cudaErrorInvalidValue;
  const bool w_ok = kF32 ? encode_w3(&tw, w, (uint64_t)I + H, H, C::BK)
                         : encode(&tw, w, (uint64_t)I + H, 4 * (uint64_t)H, C::BK, BN, CU_TENSOR_MAP_SWIZZLE_NONE,
                                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (!w_ok) return cudaErrorInvalidValue;
  auto kern = lstm_cell_skinny_kernel<T, BT>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((H + BN - 1) / BN, (B + BT - 1) / BT);
  kern<<<grid, NT, C::SMEM, stream>>>(tx, th, tw, b, c, static_cast<T*>(h_out), c_out, B, I, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* x, const void* h, const void* w, const float* b, const float* c,
                        void* h_out, float* c_out, int B, int I, int H, int bt, cudaStream_t s) {
  switch (bt) {
    case 8: return launch<T, 8>(x, h, w, b, c, h_out, c_out, B, I, H, s);
    case 16: return launch<T, 16>(x, h, w, b, c, h_out, c_out, B, I, H, s);
    case 32: return launch<T, 32>(x, h, w, b, c, h_out, c_out, B, I, H, s);
    case 64: return launch<T, 64>(x, h, w, b, c, h_out, c_out, B, I, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sk

// --- mcast: the cell between the two regimes, a cluster of the four gates --

namespace mc {

constexpr int BM = 64;               // batch rows per block: one consumer warpgroup
constexpr int BN = 64;               // hidden columns of one gate per block: one 128-byte row of W
constexpr int BK = 64;               // k per stage: 128 bytes of bf16, one swizzle row
constexpr int ROW = BK * 2;          // bytes of one row of an [x|h] tile or of the W box
constexpr int A_BYTES = BM * ROW;    // [x|h]: BM rows of one k-tile
constexpr int W_BYTES = BK * BN * 2; // the block's W box: 64 k-rows of 128 bytes
constexpr int STAGE = A_BYTES + W_BYTES;
constexpr int GATES = 4;             // blocks per cluster: one per gate
constexpr int AROWS = BM / GATES;    // [x|h] rows each block of the cluster issues
// two blocks per SM: with one, 30 clusters of four fit at once
// (cudaOccupancyMaxActiveClusters on the H100) and B = 65-128 needs 32; with
// two, 62. So the ring takes ~97 KB
constexpr int STAGES = 6;
constexpr int NT = 128 + 32;         // the consumer warpgroup, then one producer warp
constexpr int ZLD = BN + 4;          // floats per row of the z tile (padded)
constexpr int Z_BYTES = BM * ZLD * 4;
static_assert(Z_BYTES <= STAGES * STAGE, "the z tile lies over the ring once it is read");
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; release and acquire order the
// shared memory (and the barriers' initialisation) across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one 2-D box into the shared memory of every block of `mask` (cluster
// ranks), at the same offset in each, completing on each one's barrier at
// the offset of `bar`
__device__ __forceinline__ void tma_load_mcast(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                               uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

// arrive on the barrier at the offset of `bar` in the block of cluster rank
// `rank` (the default release, at CTA scope: see the header)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 ra;\n"
      " mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// the generic address of `p` (this block's shared memory) in the block of cluster rank `rank`
__device__ __forceinline__ const float* map_rank(const float* p, uint32_t rank) {
  uint64_t r;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(r) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(r);
}

// d += A (64x16, K-major) * B (16x64, N-major: transposed), bf16 in, fp32 sum
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Block g of a cluster of four computes z_g = [x|h] W_g for BM batch rows and
// the cluster's 64 hidden columns. Its stage is [x|h]'s BM rows, BM / 4 of
// them issued by each block of the cluster and multicast to all four, and
// its own W box. So a stage is filled by all four blocks, and may be refilled
// only when all four have read it: each consumer warp hands it back to the
// barrier of every block. Then the four z tiles meet through distributed
// shared memory: block g finishes hidden columns 16 g .. 16 g + 15 of the
// 64. STREAM: the consumers wait and hand back without a product (the loads
// alone, for timing).
template <bool STREAM>
__global__ void __launch_bounds__(NT, 2)
lstm_cell_mcast_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap th,
                       const __grid_constant__ CUtensorMap tw, const float* __restrict__ b,
                       const float* __restrict__ c, __nv_bfloat16* __restrict__ h_out,
                       float* __restrict__ c_out, int B, int I, int H) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  // the same offset in every block of the cluster: multicast writes there
  const uint32_t ring = (raw + 1023) & ~1023u;
  float* const z = reinterpret_cast<float*>(smem_raw + (ring - raw));  // [BM][ZLD], after the k-loop
  const uint32_t full = ring + STAGES * STAGE;
  const uint32_t empty = full + STAGES * 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x % GATES;          // this block's gate, and its rank in the cluster
  const int n0 = (blockIdx.x / GATES) * BN;  // the cluster's hidden columns
  const int m0 = blockIdx.y * BM;
  const int KX = (I + BK - 1) / BK, KT = KX + (H + BK - 1) / BK;

  if (tid == 0) {
    if (cluster_rank() != (uint32_t)g) __trap();  // the gate is the rank the multicast masks name
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);          // the producer's arrival, plus the bytes
      mbar_init(empty + 8 * s, GATES * 4);  // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // no copy or arrival reaches a block before its barriers exist

  if (warp == 4) {
    // producer: one thread issues this block's quarter of [x|h] and its W box
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, ((kt / STAGES) - 1) & 1);
        const uint32_t a = ring + s * STAGE, wt = a + A_BYTES, bar = full + 8 * s;
        mbar_expect_tx(bar, STAGE);  // what lands here, whoever issued it
        const uint32_t a_dst = a + g * AROWS * ROW;
        int wrow;
        if (kt < KX) {
          tma_load_mcast(a_dst, &tx, kt * BK, m0 + g * AROWS, bar, (1u << GATES) - 1);
          wrow = kt * BK;
        } else {
          tma_load_mcast(a_dst, &th, (kt - KX) * BK, m0 + g * AROWS, bar, (1u << GATES) - 1);
          wrow = I + (kt - KX) * BK;
        }
        tma_load(wt, &tw, g * H + n0, wrow, bar);
      }
    }
  } else {
    // the consumer warpgroup: rows m0 .. m0 + 64 of z_g
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full + 8 * s, (kt / STAGES) & 1);
      if constexpr (STREAM) {
        if (lane < GATES) mbar_arrive_remote(empty + 8 * s, lane);  // lane q tells block q
      } else {
        const uint32_t a = ring + s * STAGE, wt = a + A_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: 128-byte rows, 8-row groups 1 KB apart; a k16 slice is 32 bytes on
          // B: 128-byte k-rows of 64 columns (one swizzle atom wide), 8-row
          //    groups 1 KB apart; a k16 slice is 16 rows on
          wgmma_m64n64k16(acc, desc(a + kk * 32, 16, 1024, 1), desc(wt + kk * 16 * ROW, W_BYTES, 1024, 1));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_acc(acc);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(acc);
        if (kt > 0 && lane < GATES) mbar_arrive_remote(empty + 8 * ((kt - 1) % STAGES), lane);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    // every stage has landed (each was waited for) and been read by every
    // warp: the ring is free for the z tile
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    // acc[4 j + 2 r + e] is z_g at row 16 warp + lane / 4 + 8 r, column 8 j + 2 (lane % 4) + e
    const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(z + (r0 + 8 * r) * ZLD + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
  __syncwarp();
  cluster_sync();  // every block's z tile is written

  // the gates of hidden columns n0 + 16 g .. + 16, four at a time: z_q from block q
  const float* zq[GATES];
#pragma unroll
  for (int q = 0; q < GATES; ++q) zq[q] = map_rank(z, q);
  for (int idx = tid; idx < BM * 4; idx += NT) {
    const int r = idx >> 2, j = 16 * g + 4 * (idx & 3);
    const int m = m0 + r, n = n0 + j;
    if (m >= B || n >= H) continue;  // H % 8 == 0: n < H covers n + 3
    float4 zv[GATES], bv[GATES];
#pragma unroll
    for (int q = 0; q < GATES; ++q) {
      zv[q] = *reinterpret_cast<const float4*>(zq[q] + r * ZLD + j);
      bv[q] = *reinterpret_cast<const float4*>(b + q * H + n);
    }
    const size_t o = (size_t)m * H + n;
    const float4 cv = *reinterpret_cast<const float4*>(c + o);
    const float zi[4] = {zv[0].x + bv[0].x, zv[0].y + bv[0].y, zv[0].z + bv[0].z, zv[0].w + bv[0].w};
    const float zf[4] = {zv[1].x + bv[1].x, zv[1].y + bv[1].y, zv[1].z + bv[1].z, zv[1].w + bv[1].w};
    const float zg[4] = {zv[2].x + bv[2].x, zv[2].y + bv[2].y, zv[2].z + bv[2].z, zv[2].w + bv[2].w};
    const float zo[4] = {zv[3].x + bv[3].x, zv[3].y + bv[3].y, zv[3].z + bv[3].z, zv[3].w + bv[3].w};
    const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
    float cn[4], hn[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cn[e] = sigmoid(zf[e]) * cc[e] + sigmoid(zi[e]) * tanhf(zg[e]);
      hn[e] = sigmoid(zo[e]) * tanhf(cn[e]);
    }
    *reinterpret_cast<float4*>(c_out + o) = make_float4(cn[0], cn[1], cn[2], cn[3]);
    __nv_bfloat162 hv[2] = {__floats2bfloat162_rn(hn[0], hn[1]), __floats2bfloat162_rn(hn[2], hn[3])};
    *reinterpret_cast<uint2*>(h_out + o) = *reinterpret_cast<const uint2*>(hv);
  }
  __syncwarp();
  cluster_sync();  // no block leaves while another still reads its z tile
}

// The launch's cluster attribute and shape, for the launch and for the
// occupancy query.
cudaLaunchConfig_t config(cudaLaunchAttribute* attr, dim3 grid, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = GATES;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many of the kernel's clusters run at once on this card: with its own
// shared memory (two blocks per SM) and with one block per SM's worth.
cudaError_t clusters(int* at_two, int* at_one) {
  auto kern = lstm_cell_mcast_kernel<false>;
  constexpr int ONE_PER_SM = 120 * 1024;  // more than half of an SM's shared memory
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, ONE_PER_SM);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(attr, dim3(GATES * 32), SMEM, nullptr);
  e = cudaOccupancyMaxActiveClusters(at_two, kern, &cfg);
  if (e != cudaSuccess) return e;
  cfg.dynamicSmemBytes = ONE_PER_SM;
  return cudaOccupancyMaxActiveClusters(at_one, kern, &cfg);
}

template <bool STREAM>
cudaError_t launch(const void* x, const void* h, const void* w, const float* b, const float* c, void* h_out,
                   float* c_out, int B, int I, int H, cudaStream_t stream) {
  CUtensorMap tx, th, tw;
  const auto promo = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode(&tx, x, B, I, AROWS, BK, sw, promo) || !encode(&th, h, B, H, AROWS, BK, sw, promo) ||
      !encode(&tw, w, (uint64_t)I + H, 4 * (uint64_t)H, BK, BN, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return cudaErrorInvalidValue;
  auto kern = lstm_cell_mcast_kernel<STREAM>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(attr, dim3(GATES * ((H + BN - 1) / BN), (B + BM - 1) / BM), SMEM, stream);
  e = cudaLaunchKernelEx(&cfg, kern, tx, th, tw, b, c, static_cast<__nv_bfloat16*>(h_out), c_out, B, I, H);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace mc

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

// The 3xTF32 design, fp32 only. wt is [2, 4H, I+H]: W^T rounded to TF32,
// then the TF32 rounding of W^T minus it (ops/lstm.py `tf32x3_weight`). I
// and H multiples of 4; x, h, wt, b, c, h_out and c_out 16-byte aligned; 64
// batch rows per block. Returns a cudaError_t.
extern "C" int sat_lstm_cell_tf32x3(const void* x, const void* h, const void* wt, const float* b,
                                    const float* c, void* h_out, float* c_out, int B, int I, int H,
                                    void* stream) {
  if (B <= 0 || I <= 0 || H <= 0 || I % 4 || H % 4) return (int)cudaErrorInvalidValue;
  return (int)sm90::t3::launch_tf32x3(x, h, wt, b, c, h_out, c_out, B, I, H, static_cast<cudaStream_t>(stream));
}

// The small-batch design, fp32 (dtype 0: FMAs) or bf16 (dtype 1: mma.sync).
// W is [I+H, 4H] as it is. I and H multiples of 4 (fp32) or 8 (bf16); x, h,
// w 16-byte aligned; bt (batch rows per block) 8, 16, 32 or 64. Returns a
// cudaError_t.
extern "C" int sat_lstm_cell_skinny(const void* x, const void* h, const void* w, const float* b,
                                    const float* c, void* h_out, float* c_out, int B, int I, int H,
                                    int bt, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int align = dtype == 0 ? 4 : 8;
  if (B <= 0 || I <= 0 || H <= 0 || I % align || H % align) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)sm90::sk::launch_rows<float>(x, h, w, b, c, h_out, c_out, B, I, H, bt, s);
  if (dtype == 1)
    return (int)sm90::sk::launch_rows<__nv_bfloat16>(x, h, w, b, c, h_out, c_out, B, I, H, bt, s);
  return (int)cudaErrorInvalidValue;
}

// The design between the two regimes, bf16 only: clusters of four blocks,
// one per gate, over 64 hidden columns and 64 batch rows, sharing [x|h]'s
// tiles by TMA multicast. I and H multiples of 8; x, h, w, b, c, h_out and
// c_out 16-byte aligned. stream_only = 1 times the loads alone: the consumers
// wait and hand each stage back without a product, and h' and c' are not the
// cell's. Returns a cudaError_t.
extern "C" int sat_lstm_cell_mcast(const void* x, const void* h, const void* w, const float* b,
                                   const float* c, void* h_out, float* c_out, int B, int I, int H,
                                   int stream_only, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || I <= 0 || H <= 0 || I % 8 || H % 8) return (int)cudaErrorInvalidValue;
  return stream_only ? (int)sm90::mc::launch<true>(x, h, w, b, c, h_out, c_out, B, I, H, s)
                     : (int)sm90::mc::launch<false>(x, h, w, b, c, h_out, c_out, B, I, H, s);
}

// The clusters of `sat_lstm_cell_mcast` that run at once on the current
// card (cudaOccupancyMaxActiveClusters): at_two with its own shared memory,
// at_one with one block per SM's worth. Returns a cudaError_t.
extern "C" int sat_lstm_cell_mcast_clusters(int* at_two, int* at_one) {
  return (int)sm90::mc::clusters(at_two, at_one);
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
