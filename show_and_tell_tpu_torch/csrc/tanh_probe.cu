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
// `rcp.approx`. A tanh can also run as a polynomial on the FMA pipe
// (`sat::tanh_poly_bf16x2`, ~12 instructions per element against the 8 issue
// slots that pass per MUFU operation), so over both pipes the tanh side can
// fall to ~14.7 us, below the bytes. What the card reaches is what the probe
// measures, so the form of the tanh is an argument:
//   0  tanh.approx.bf16x2 on add.bf16x2 (bf16 inputs only)
//   1  tanh.approx.f32
//   2  1 - 2 / (1 + 2^(2x log2 e)) from ex2.approx and rcp.approx
//   3  the precise tanhf
//   4-8  split<P>, P = 0..4 (bf16 inputs only): the ring design below; of
//        each 16-byte vector's 4 pairs the first P take the polynomial and
//        the rest `tanh.approx.bf16x2` as form 0. The share is fixed at
//        compile time, so no warp diverges.
//
// Forms 0-3 run the first design: a block is 64 threads along d times 4
// groups of patch rows. A thread owns one 16-byte vector of d (8 bf16 or 4
// fp32 elements; one element where D or the alignment rule vectors out) and
// walks its rows 7 at a time, the next 7 ce vectors on their way in its
// registers while it sums the tanh of these; each hp vector, read from shared
// memory, serves 7 rows. The split forms take it where the vectors do not
// fit (one element per thread; there rows u % 4 < P take the polynomial).
//
// The ring design (split<P> on 16-byte vectors): the first design's loads
// come in bursts, one batch per thread per step, so the card's memory idles
// while the warps sum, and ce is read no faster than a plain read of it. Here
// a producer warp streams the block's slice of ce, RING_ROWS patch rows at a
// time, into a ring of RING_STAGES stages by bulk asynchronous copies, each
// stage's landing counted on an mbarrier and its release by the consumer
// warps on another: three stages (24 KB per block) are always on their way,
// and no consumer thread spends an instruction or a register on a load. The
// consumers (64 threads along d, 4 row groups) hold hp in registers and
// read each row of a stage once from shared memory, for all K. At the
// serving K = 3 the loop over k is unrolled at compile time, so that the
// scheduler sees 48 tanh at once. ce is read from device memory exactly once,
// whatever K. The row groups' sums meet in shared memory at the end.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 4, PERF.md):
// with the stream out of the way (`tanh_rate`), MUFU.TANH.BF16 sustains ~15.8
// operations per clock per SM, and a quarter of the elements on the
// polynomial lifts the two pipes together to ~16.8 tanh per clock per SM;
// more on the polynomial is slower. In this streaming kernel at K = 3 the
// split loses (its longer dependent chain, with 16 consumer warps per SM):
// split0 is the fastest form, and ce's stream, not the tanh, sets its pace.

#include "sat_common.cuh"

namespace {

constexpr int TX = 64;  // threads along d
constexpr int TY = 4;   // groups of patch rows
constexpr int NT = TX * TY;
constexpr int U = 7;    // rows per thread in flight
constexpr int KMAX = 8;

enum Form {
  BF16X2 = 0, APPROX_F32 = 1, EX2_RCP = 2, PRECISE = 3,
  SPLIT0 = 4, SPLIT1 = 5, SPLIT2 = 6, SPLIT3 = 7, SPLIT4 = 8
};

constexpr int PAIRS = 4;  // bf16 pairs in a 16-byte vector

// the pairs of each vector whose tanh a form runs as the polynomial
template <int FORM>
__host__ __device__ constexpr int poly_pairs() {
  return FORM >= SPLIT0 ? FORM - SPLIT0 : 0;
}

template <int FORM>
__device__ __forceinline__ float tanh_f32(float x) {
  if constexpr (FORM == APPROX_F32) return sat::tanh_approx_f32(x);
  else if constexpr (FORM == EX2_RCP) return sat::tanh_ex2(x);
  else return tanhf(x);
}

// tanh of a packed pair by form 0 or, for the pairs a split form sends
// there, by the polynomial
template <int FORM>
__device__ __forceinline__ __nv_bfloat162 tanh_pair(__nv_bfloat162 s, bool poly) {
  return poly_pairs<FORM>() && poly ? sat::tanh_poly_bf16x2(s) : sat::tanh_bf16x2(s);
}

// acc[q] += tanh(ce[q] + hp[q]) over a 16-byte vector of 4 bf16 pairs, the
// first P by the polynomial
template <int FORM>
__device__ __forceinline__ void add_vec(float (&acc)[8], const uint4& ce, const uint4& hp) {
  const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&ce);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hp);
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const float2 t = __bfloat1622float2(tanh_pair<FORM>(__hadd2(c2[p], h2[p]), p < poly_pairs<FORM>()));
    acc[2 * p] += t.x;
    acc[2 * p + 1] += t.y;
  }
}

// acc[q] += tanh(ce[q] + hp[q]) over the VEC elements of two raw vectors of
// patch row u of a batch (with one element per thread, a split form sends
// rows u % PAIRS < P to the polynomial).
template <typename T, int VEC, int FORM>
__device__ __forceinline__ void add_tanh(float (&acc)[VEC], const T* ce, const T* hp, int u) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (FORM == BF16X2 || FORM >= SPLIT0) {  // packed pairs
      if constexpr (VEC == 1) {
        const __nv_bfloat162 s = tanh_pair<FORM>(
            __hadd2(__halves2bfloat162(ce[0], ce[0]), __halves2bfloat162(hp[0], hp[0])),
            u % PAIRS < poly_pairs<FORM>());
        acc[0] += __low2float(s);
      } else {
        add_vec<FORM>(acc, *reinterpret_cast<const uint4*>(ce), *reinterpret_cast<const uint4*>(hp));
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
          if (l0 + u * TY < L) add_tanh<T, VEC, FORM>(acc, rows[u].v, h.v, u);
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

// ---- the ring design (split<P> on 16-byte vectors)

constexpr int RX = 64;                       // consumer threads along d, 8 elements each
constexpr int RY = 4;                        // consumer row groups
constexpr int RU = 2;                        // rows of a stage per consumer thread
constexpr int RING_ROWS = RY * RU;           // patch rows per stage
constexpr int RING_STAGES = 4;
constexpr int RING_W = RX * 8;               // elements of d per block
constexpr int RING_CONSUMERS = RX * RY;      // threads; one producer warp follows them

__device__ __forceinline__ void mbar_init_count(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// KC: K known at compile time (0: any K up to KMAX)
template <int FORM, int KC>
__global__ void __launch_bounds__(RING_CONSUMERS + 32)
tanh_probe_ring(const __nv_bfloat16* __restrict__ ce, const __nv_bfloat16* __restrict__ hp,
                float* __restrict__ out, int K, int L, int D) {
  using bf16 = __nv_bfloat16;
  // the ring, then (once it is drained) the row groups' sums
  __shared__ __align__(128) uint4 ring_raw[RING_STAGES][RING_ROWS * RING_W / 8];
  __shared__ uint4 s_hp[KMAX * RX];
  __shared__ uint64_t bars[2 * RING_STAGES];  // full, then empty
  auto ring = [&](int s) { return reinterpret_cast<bf16*>(ring_raw[s]); };
  const int b = blockIdx.y;
  const int dbase = blockIdx.x * RING_W;
  const int width = min(RING_W, D - dbase);     // elements of this block's slice
  const int stride = width == D ? D : RING_W;   // a stage's row stride
  const int nchunks = (L + RING_ROWS - 1) / RING_ROWS;
  const uint32_t full0 = sat::smem_u32(bars), empty0 = sat::smem_u32(bars + RING_STAGES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_STAGES; ++s) {
      mbar_init_count(full0 + 8 * s, 1);
      mbar_init_count(empty0 + 8 * s, RING_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < K * RX; i += blockDim.x) {
    const int k = i / RX, d = dbase + (i % RX) * 8;
    if (d < D) s_hp[i] = *reinterpret_cast<const uint4*>(hp + ((size_t)b * K + k) * D + d);
  }
  __syncthreads();
  if (threadIdx.x >= RING_CONSUMERS) {  // the producer warp: one lane issues the copies
    if (threadIdx.x == RING_CONSUMERS) {
      const bf16* src = ce + (size_t)b * L * D + dbase;
      const uint32_t row_bytes = width * sizeof(bf16);
      for (int c = 0; c < nchunks; ++c) {
        const int s = c % RING_STAGES;
        if (c >= RING_STAGES) sat::mbar_wait(empty0 + 8 * s, (c / RING_STAGES - 1) & 1);
        const int rows = min(RING_ROWS, L - c * RING_ROWS);
        sat::expect_bytes(full0 + 8 * s, rows * row_bytes);
        if (width == D) {  // the slice is whole rows: one copy
          sat::bulk_copy(full0 + 8 * s, ring(s), src + (size_t)c * RING_ROWS * D, rows * row_bytes);
        } else {
          for (int r = 0; r < rows; ++r)
            sat::bulk_copy(full0 + 8 * s, ring(s) + r * RING_W, src + (size_t)(c * RING_ROWS + r) * D, row_bytes);
        }
      }
    }
    return;
  }
  const int tx = threadIdx.x % RX, ty = threadIdx.x / RX;
  const bool live = tx * 8 < width;
  uint4 h[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    if (k < K) h[k] = s_hp[k * RX + tx];
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % RING_STAGES;
    sat::mbar_wait(full0 + 8 * s, (c / RING_STAGES) & 1);
    const bf16* stage = ring(s) + tx * 8;
    const int rows = min(RING_ROWS, L - c * RING_ROWS);
    if (live && rows == RING_ROWS) {
      uint4 v[RU];
#pragma unroll
      for (int u = 0; u < RU; ++u) v[u] = *reinterpret_cast<const uint4*>(stage + (ty + u * RY) * stride);
      if constexpr (KC > 0) {
#pragma unroll
        for (int k = 0; k < KC; ++k)
#pragma unroll
          for (int u = 0; u < RU; ++u) add_vec<FORM>(acc, v[u], h[k]);
      } else {
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k < K) {
#pragma unroll
            for (int u = 0; u < RU; ++u) add_vec<FORM>(acc, v[u], h[k]);
          }
      }
    } else if (live) {  // the last, short stage
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        if (ty + u * RY < rows) {
          const uint4 v = *reinterpret_cast<const uint4*>(stage + (ty + u * RY) * stride);
#pragma unroll
          for (int k = 0; k < KMAX; ++k)
            if (k < K) add_vec<FORM>(acc, v, h[k]);
        }
      }
    }
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty0 + 8 * s);
  }
  // every stage has landed and been read: the ring takes the sums
  asm volatile("bar.sync 1, %0;\n" ::"n"(RING_CONSUMERS));
  float* s_sum = reinterpret_cast<float*>(ring_raw);  // [RY][RING_W]
#pragma unroll
  for (int q = 0; q < 8; ++q) s_sum[ty * RING_W + tx * 8 + q] = acc[q];
  asm volatile("bar.sync 1, %0;\n" ::"n"(RING_CONSUMERS));
  for (int i = threadIdx.x; i < width; i += RING_CONSUMERS) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < RY; ++g) t += s_sum[g * RING_W + i];
    out[(size_t)b * D + dbase + i] = t;
  }
}

template <int FORM>
cudaError_t launch_ring(const void* ce, const void* hp, float* out, int B, int K, int L, int D,
                        cudaStream_t s) {
  const dim3 grid((D + RING_W - 1) / RING_W, B);
  const auto* c = static_cast<const __nv_bfloat16*>(ce);
  const auto* h = static_cast<const __nv_bfloat16*>(hp);
  if (K == 3)
    tanh_probe_ring<FORM, 3><<<grid, RING_CONSUMERS + 32, 0, s>>>(c, h, out, K, L, D);
  else
    tanh_probe_ring<FORM, 0><<<grid, RING_CONSUMERS + 32, 0, s>>>(c, h, out, K, L, D);
  return cudaGetLastError();
}

template <typename T, int FORM>
cudaError_t launch_vec(const void* ce, const void* hp, float* out, int B, int K, int L, int D,
                       int vec, cudaStream_t s) {
  if constexpr (FORM >= SPLIT0) {
    if (vec) return launch_ring<FORM>(ce, hp, out, B, K, L, D, s);
    return launch<T, 1, FORM>(ce, hp, out, B, K, L, D, s);
  } else {
    return vec ? launch<T, 16 / sizeof(T), FORM>(ce, hp, out, B, K, L, D, s)
               : launch<T, 1, FORM>(ce, hp, out, B, K, L, D, s);
  }
}

// ---- the compute-only loop of the split forms: the ring's per-pair work
// (add.bf16x2, the tanh by the form's share, the fp32 accumulate) on values
// held in registers, with no memory traffic, so that what the two pipes
// sustain shows apart from the stream. Each thread starts from its 16 pairs
// of x0 and adds hp's 4 pairs (its 16-byte vector) to them `iters` times,
// summing the tanh of every sum.
template <int FORM>
__global__ void __launch_bounds__(256)
tanh_rate_kernel(const uint4* __restrict__ x0, const uint4* __restrict__ hp, float* __restrict__ out, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  uint4 x[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) x[v] = x0[t * 4 + v];
  const uint4 h = *hp;
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&h);
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&x[v]);
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        x2[p] = __hadd2(x2[p], h2[p]);
        const float2 y = __bfloat1622float2(tanh_pair<FORM>(x2[p], p < poly_pairs<FORM>()));
        acc[2 * p] += y.x;
        acc[2 * p + 1] += y.y;
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) sum += acc[q];
  out[t] = sum;
}

template <int FORM>
cudaError_t launch_rate(const void* x0, const void* hp, float* out, int n, int iters, cudaStream_t s) {
  tanh_rate_kernel<FORM><<<n / 256, 256, 0, s>>>(static_cast<const uint4*>(x0), static_cast<const uint4*>(hp),
                                                 out, iters);
  return cudaGetLastError();
}

}  // namespace

// ce [B, L, D], hp [B, K, D] -> out [B, D] fp32. dtype: 0 = float32, 1 =
// bfloat16. form: see `Form` (0 and 4-8 need bfloat16). vec: 1 when D is a multiple
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
      case SPLIT0: return (int)launch_vec<bf16, SPLIT0>(ce, hp, out, B, K, L, D, vec, s);
      case SPLIT1: return (int)launch_vec<bf16, SPLIT1>(ce, hp, out, B, K, L, D, vec, s);
      case SPLIT2: return (int)launch_vec<bf16, SPLIT2>(ce, hp, out, B, K, L, D, vec, s);
      case SPLIT3: return (int)launch_vec<bf16, SPLIT3>(ce, hp, out, B, K, L, D, vec, s);
      case SPLIT4: return (int)launch_vec<bf16, SPLIT4>(ce, hp, out, B, K, L, D, vec, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The compute-only loop of split form `form` (4-8): x0 [n, 32] bf16 (16-byte
// aligned), hp [8] bf16 (its 4 pairs), n a multiple of 256 -> out [n] fp32.
// Returns a cudaError_t.
extern "C" int sat_tanh_rate(const void* x0, const void* hp, float* out, int n, int iters, int form,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n % 256 || iters < 0) return (int)cudaErrorInvalidValue;
  switch (form) {
    case SPLIT0: return (int)launch_rate<SPLIT0>(x0, hp, out, n, iters, s);
    case SPLIT1: return (int)launch_rate<SPLIT1>(x0, hp, out, n, iters, s);
    case SPLIT2: return (int)launch_rate<SPLIT2>(x0, hp, out, n, iters, s);
    case SPLIT3: return (int)launch_rate<SPLIT3>(x0, hp, out, n, iters, s);
    case SPLIT4: return (int)launch_rate<SPLIT4>(x0, hp, out, n, iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
