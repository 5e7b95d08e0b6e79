// The whole B=1 detector step in one persistent kernel, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `StreamingMegakernel._run_pallas`
// (snn_for_object_detection_tpu/ops/megakernel.py, its pallas_call):
//   in:  one frame [H, W, Cin] (uint8, fp32 or bf16; the TPU kernel cast
//        it outside), every conv weight as [k*k, Cin, Cout] taps and
//        every folded BatchNorm (k, b), all in the compute type X, and
//        the state slots [H, W, C] in the state type S;
//   out: the box and cls maps of every head (fp32, concatenated in
//        anchor order) and the new state slots.
// The layer menu is the TPU kernel's: k x k convs (k in {1, 3}, stride
// in {1, 2}, zero padding k / 2), the folded BatchNorm, LIF / LI, ReLU,
// SiLU, Tanh, Pool with kernel == stride (max, mean, sum), nearest Up,
// Residual sums and Dense concatenations. The program is an op table
// built once on the host (ops/megakernel.py): the kernel interprets it.
//
// Rounding follows the plain version (ops/megakernel.py,
// streaming_megakernel_reference), which follows the JAX body: each conv
// sums in fp32 and rounds to X; the affine is one fused multiply-add at
// fp32, and in bf16 a rounded product plus an fp32 sum handed to the
// following cell or activation unrounded; the cell update is
// cell_math.cuh's (the sources build with --fmad=false); the cell
// output, activations, pool sums and residual adds round to X. The conv
// sums in another order than the plain version, and tanhf / expf are not
// XLA's, so the two agree to spike agreement, not bit for bit.
//
// What bounds it: operations. A GEN1 TinyYolo frame is 3.81 G
// multiply-adds (48 convs) against 17 MB of fp32 weights and 42 MB of
// fp32 state read and written once: at 67 TFLOP/s fp32 the math alone
// takes 0.11 ms, the bytes 0.03 ms.
//
// Design. On the TPU everything sat in VMEM for the frame; a Hopper SM
// has 227 KB of shared memory, so weights, states and activations live
// in device memory, mostly in the 50 MB L2. What the kernel keeps of the
// TPU kernel is one program per frame with no host round trip between
// layers:
//   - one cooperative launch (all blocks co-resident: the grid is the
//     occupancy times the SM count) walks the phases of the op table;
//     ops of one phase are independent (their inputs were written in
//     earlier phases), and the blocks take their tiles in a grid-stride
//     loop; a grid-wide barrier (a sense-reversing counter in device
//     memory with __threadfence) separates phases;
//   - a conv is an implicit GEMM over M = Ho*Wo pixels, N = Cout, K =
//     k*k*Cin: a block computes a 64 x 64 (or, for Cout <= 32, 128 x 32)
//     output tile with a 4 x 4 fp32 register tile a thread, staging
//     K-chunks of 16 of the gathered input (zero padding by bounds
//     checks) and the weights in shared memory, the next chunk's loads
//     in flight during the current chunk's FFMAs. The Norm, the LIF / LI
//     update and a following activation run in its epilogue, so a conv
//     output goes to memory once, already through its cell;
//   - a conv whose tiles fill less than half the grid (the 60x76 and
//     deeper layers: 4-252 tiles for 264 blocks) is split along K into up
//     to 16 slices of whole chunks: each slice's tile writes its fp32
//     partial sums to scratch, and a reduce op in the next phase adds the
//     slices in order and runs the epilogue (deterministic, no atomics);
//   - Pool, Up, Residual adds and Dense copies are elementwise phases;
//   - reads of data written during the launch bypass L1 (ld.global.cg),
//     since L1 is not coherent across SMs; buffers are 128-byte aligned.
// Known limits (PERF.md): FFMA only (no tensor cores, so bf16 runs at
// the fp32 rate); the inner loop waits on its staging loads and two
// block barriers a chunk; one grid barrier per phase; residual adds and
// Dense copies are phases of their own.

#include <type_traits>

#include "cell_math.cuh"

namespace {

using cell_math::E5M2;
using cell_math::from_f32;
using cell_math::kLI;
using cell_math::kLIF;
using cell_math::round_to;
using cell_math::to_f32;

// op table fields (ops/cuda_kernels.py, _MK_FIELDS)
enum Field {
  F_KIND, F_SRC_SPACE, F_SRC_OFF, F_RES_SPACE, F_RES_OFF, F_DST_SPACE,
  F_DST_OFF, F_H, F_W, F_CIN, F_HO, F_WO, F_COUT, F_K, F_STRIDE, F_W_OFF,
  F_NK_OFF, F_NB_OFF, F_CELL, F_SLOT_V, F_SLOT_I, F_ACT, F_POOL, F_DST_C,
  F_CH_OFF, F_TILES, F_TILE0, F_BN, F_SPLIT, F_SCRATCH_OFF,
};
constexpr int kRow = 32;
enum Kind { kConv = 0, kEw, kPool, kUp, kAdd, kCopy, kReduce };
enum Space { kWs = 0, kFrame, kPreds, kScratch };
enum Act { kNoAct = 0, kRelu, kSilu, kTanh };
enum Pool { kMax = 0, kMean, kSum };

constexpr int kThreads = 256;
constexpr int kMaxSlots = 128;
constexpr int kBK = 16;       // K-chunk of a conv tile
constexpr int kEwTile = 1024; // elements of an elementwise tile
constexpr int kSmemFloats = kBK * (128 + 4) + kBK * 32;

struct Args {
  const int* ops;
  const int* phases;  // [n_phases][3]: first op, end op, tiles
  int n_phases;
  const void* weights;
  void* ws;
  const void* frame;
  int frame_dtype;  // 0 fp32, 1 bf16, 3 uint8
  float* preds;
  float* scratch;  // fp32 partial sums of the split convs
  unsigned int* barrier;  // [arrivals, generation]
  float c_mem[2], c_syn[2];  // LIF, LI
  // optional: the global timer (ns) at the start and at the end of every
  // phase, written by block 0 after each barrier
  unsigned long long* timeline;
  const void* s_in[kMaxSlots];
  void* s_out[kMaxSlots];
};

__device__ __forceinline__ float ldcg_f32(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f32(const __nv_bfloat16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

// an activation value (a value of X, widened to fp32)
template <typename X>
__device__ __forceinline__ float load_act(const Args& a, int space,
                                          int64_t idx) {
  if (space == kWs) return ldcg_f32(static_cast<const X*>(a.ws) + idx);
  if (space == kPreds) return __ldcg(a.preds + idx);
  if (space == kScratch) return __ldcg(a.scratch + idx);
  float v;
  if (a.frame_dtype == 0) {
    v = static_cast<const float*>(a.frame)[idx];
  } else if (a.frame_dtype == 1) {
    v = to_f32(static_cast<const __nv_bfloat16*>(a.frame)[idx]);
  } else {
    v = static_cast<float>(static_cast<const unsigned char*>(a.frame)[idx]);
  }
  return round_to<X>(v);  // the frame's cast to X
}

template <typename X>
__device__ __forceinline__ void store_act(const Args& a, int space,
                                          int64_t idx, float v) {
  if (space == kPreds) {
    a.preds[idx] = v;
  } else {
    static_cast<X*>(a.ws)[idx] = from_f32<X>(v);
  }
}

template <typename X>
__device__ __forceinline__ float load_w(const Args& a, int off) {
  return to_f32(static_cast<const X*>(a.weights)[off]);
}

// the epilogue chain of a conv or elementwise op: Norm, cell, activation
struct Epi {
  int nk, nb, cell, sv, si, act;
};

__device__ __forceinline__ Epi epi_of(const int* op) {
  return Epi{op[F_NK_OFF], op[F_NB_OFF], op[F_CELL], op[F_SLOT_V],
             op[F_SLOT_I], op[F_ACT]};
}

template <typename X, typename S>
__device__ __forceinline__ float epilogue(const Args& a, const Epi& e,
                                          float y, int n, int64_t sidx) {
  y = round_to<X>(y);
  if (e.nk >= 0) {
    const float k = load_w<X>(a, e.nk + n), b = load_w<X>(a, e.nb + n);
    if (std::is_same<X, float>::value) {
      y = __fmaf_rn(y, k, b);
    } else {
      y = __fadd_rn(round_to<X>(__fmul_rn(y, k)), b);
      if (e.cell < 0 && e.act == kNoAct) y = round_to<X>(y);
    }
  }
  if (e.cell >= 0) {
    float v = to_f32(static_cast<const S*>(a.s_in[e.sv])[sidx]);
    float i = to_f32(static_cast<const S*>(a.s_in[e.si])[sidx]);
    const float out =
        e.cell == kLIF
            ? cell_math::cell_step<kLIF>(y, v, i, a.c_mem[0], a.c_syn[0])
            : cell_math::cell_step<kLI>(y, v, i, a.c_mem[1], a.c_syn[1]);
    static_cast<S*>(a.s_out[e.sv])[sidx] = from_f32<S>(v);
    static_cast<S*>(a.s_out[e.si])[sidx] = from_f32<S>(i);
    y = round_to<X>(out);
  }
  if (e.act != kNoAct) {
    if (e.act == kRelu) {
      y = y < 0.0f ? 0.0f : y;
    } else if (e.act == kSilu) {
      y = __fdiv_rn(y, __fadd_rn(1.0f, expf(-y)));
    } else {
      y = tanhf(y);
    }
    y = round_to<X>(y);
  }
  return y;
}

// One BM x BN output tile of a conv (implicit GEMM, see the note above),
// or of one K-slice of a split conv, whose fp32 partial sums go to
// scratch for the reduce op of the next phase.
template <typename X, typename S, int BN>
__device__ __noinline__ void conv_tile(const Args& a, const int* op, int t,
                                       float* smem) {
  constexpr int BM = 4096 / BN;  // 64 or 128 rows: 4 x 4 a thread
  constexpr int TN = BN / 4;     // threads along N
  constexpr int AS = BM + 4;     // row stride of the staged input
  constexpr int JA = BM / 16;    // input values a thread stages a chunk
  constexpr int JB = BN / 16;    // weights a thread stages a chunk
  float* As = smem;              // [kBK][AS]
  float* Bs = smem + kBK * AS;   // [kBK][BN]

  const int H = op[F_H], W = op[F_W], Cin = op[F_CIN];
  const int Wo = op[F_WO], Cout = op[F_COUT];
  const int k = op[F_K], stride = op[F_STRIDE], pad = k / 2;
  const int M = op[F_HO] * Wo, K = k * k * Cin;
  const int src_space = op[F_SRC_SPACE], src_off = op[F_SRC_OFF];
  const X* __restrict__ w = static_cast<const X*>(a.weights) + op[F_W_OFF];
  const int n_tiles = (Cout + BN - 1) / BN;
  const int split = op[F_SPLIT];
  const int mn_tiles = ((M + BM - 1) / BM) * n_tiles;
  const int slice = t / mn_tiles;
  t -= slice * mn_tiles;
  const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
  // this slice's K range, in whole chunks
  const int chunks = (K + kBK - 1) / kBK;
  const int k_lo = (slice * chunks / split) * kBK;
  const int k_hi = min(K, ((slice + 1) * chunks / split) * kBK);
  const int tid = threadIdx.x;

  // staging roles: input rows (k) by tid % 16, pixels by tid / 16
  const int kk_a = tid % kBK;
  int iy0[JA], ix0[JA];
#pragma unroll
  for (int j = 0; j < JA; ++j) {
    const int m = m0 + tid / kBK + 16 * j;
    if (m < M) {
      iy0[j] = (m / Wo) * stride - pad;
      ix0[j] = (m % Wo) * stride - pad;
    } else {
      iy0[j] = -0x40000000;  // never inside the map
      ix0[j] = 0;
    }
  }
  const int nn_b = tid % BN;
  const int kk_b = tid / BN;
  float pa[JA], pb[JB];

  auto load_chunk = [&](int k0) {
    const int kg = k0 + kk_a;
    int dy = 0, dx = 0, ci = 0;
    const bool kin = kg < K;
    if (kin) {
      const int tap = kg / Cin;
      ci = kg - tap * Cin;
      dy = tap / k;
      dx = tap - dy * k;
    }
#pragma unroll
    for (int j = 0; j < JA; ++j) {
      const int iy = iy0[j] + dy, ix = ix0[j] + dx;
      pa[j] = kin && iy >= 0 && iy < H && ix >= 0 && ix < W
                  ? load_act<X>(a, src_space,
                                src_off +
                                    (static_cast<int64_t>(iy) * W + ix) *
                                        Cin + ci)
                  : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < JB; ++j) {
      const int kr = k0 + kk_b + (kThreads / BN) * j;
      const int n = n0 + nn_b;
      pb[j] = kr < K && n < Cout
                  ? to_f32(w[static_cast<int64_t>(kr) * Cout + n])
                  : 0.0f;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  const int tm = tid / TN, tn = tid % TN;

  load_chunk(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll
    for (int j = 0; j < JA; ++j) As[kk_a * AS + tid / kBK + 16 * j] = pa[j];
#pragma unroll
    for (int j = 0; j < JB; ++j) {
      Bs[(kk_b + (kThreads / BN) * j) * BN + nn_b] = pb[j];
    }
    __syncthreads();
    if (k0 + kBK < k_hi) load_chunk(k0 + kBK);  // in flight during the math
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(As + kk * AS +
                                                         tm * 4);
      const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * BN +
                                                         tn * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
        }
      }
    }
  }

  const Epi e = epi_of(op);
  const int dst_space = op[F_DST_SPACE], dst_off = op[F_DST_OFF];
  const int dst_c = op[F_DST_C], ch_off = op[F_CH_OFF];
  float* part = a.scratch + op[F_SCRATCH_OFF] +
                static_cast<int64_t>(slice) * M * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) continue;
    if (split > 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tn * 4 + j;
        if (n < Cout) part[static_cast<int64_t>(m) * Cout + n] = acc[i][j];
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n >= Cout) continue;
      const float y = epilogue<X, S>(
          a, e, acc[i][j], n, static_cast<int64_t>(m) * Cout + n);
      store_act<X>(a, dst_space,
                   dst_off + static_cast<int64_t>(m) * dst_c + ch_off + n, y);
    }
  }
}

// One tile of an elementwise op: 4 elements a thread.
template <typename X, typename S>
__device__ __noinline__ void elementwise_tile(const Args& a, const int* op,
                                              int t) {
  const int kind = op[F_KIND];
  const int W = op[F_W], C = op[F_CIN];
  const int Ho = op[F_HO], Wo = op[F_WO];
  const int src_space = op[F_SRC_SPACE], src_off = op[F_SRC_OFF];
  const int dst_space = op[F_DST_SPACE], dst_off = op[F_DST_OFF];
  const int dst_c = op[F_DST_C], ch_off = op[F_CH_OFF];
  const int k = op[F_K];
  const int64_t numel = (kind == kPool || kind == kUp)
                            ? static_cast<int64_t>(Ho) * Wo * C
                            : static_cast<int64_t>(op[F_H]) * W * C;
  const Epi e = epi_of(op);
  for (int r = 0; r < kEwTile / kThreads; ++r) {
    const int64_t idx =
        static_cast<int64_t>(t) * kEwTile + r * kThreads + threadIdx.x;
    if (idx >= numel) return;
    const int c = static_cast<int>(idx % C);
    const int64_t pix = idx / C;
    float y;
    if (kind == kEw) {
      y = epilogue<X, S>(a, e, load_act<X>(a, src_space, src_off + idx), c,
                         idx);
    } else if (kind == kReduce) {  // a split conv's slices, in order
      float sum = 0.0f;
      for (int s = 0; s < k; ++s) {
        sum = __fadd_rn(sum, __ldcg(a.scratch + src_off + s * numel + idx));
      }
      y = epilogue<X, S>(a, e, sum, c, idx);
    } else if (kind == kAdd) {
      y = round_to<X>(
          __fadd_rn(load_act<X>(a, src_space, src_off + idx),
                    load_act<X>(a, op[F_RES_SPACE], op[F_RES_OFF] + idx)));
    } else if (kind == kCopy) {
      y = load_act<X>(a, src_space, src_off + idx);
    } else {
      const int oy = static_cast<int>(pix / Wo);
      const int ox = static_cast<int>(pix % Wo);
      if (kind == kUp) {
        y = load_act<X>(
            a, src_space,
            src_off + (static_cast<int64_t>(oy / k) * W + ox / k) * C + c);
      } else {
        const int pool = op[F_POOL];
        float m = 0.0f;
        for (int dy = 0; dy < k; ++dy) {
          for (int dx = 0; dx < k; ++dx) {
            const float v = load_act<X>(
                a, src_space,
                src_off +
                    (static_cast<int64_t>(oy * k + dy) * W + ox * k + dx) *
                        C + c);
            if (pool == kMax) {
              m = (dy == 0 && dx == 0) || v > m ? v : m;
            } else {
              m = __fadd_rn(m, v);
            }
          }
        }
        if (pool == kMean) m = __fdiv_rn(m, static_cast<float>(k * k));
        y = round_to<X>(m);
      }
    }
    store_act<X>(a, dst_space, dst_off + pix * dst_c + ch_off + c, y);
  }
}

// Grid-wide barrier: every block arrives on a counter; the last one
// resets it and bumps the generation the others spin on. Valid because
// the cooperative launch keeps every block resident.
__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == blocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void mark_time(const Args& a, int n) {
  if (a.timeline != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.timeline[n] = t;
  }
}

template <typename X, typename S>
__global__ void __launch_bounds__(kThreads, 2)
    megakernel(const __grid_constant__ Args a) {
  __shared__ __align__(16) float smem[kSmemFloats];
  mark_time(a, 0);
  for (int p = 0; p < a.n_phases; ++p) {
    const int o0 = a.phases[3 * p], o1 = a.phases[3 * p + 1];
    const int tiles = a.phases[3 * p + 2];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int o = o0;
      while (o + 1 < o1 && t >= a.ops[(o + 1) * kRow + F_TILE0]) ++o;
      const int* op = a.ops + o * kRow;
      const int lt = t - op[F_TILE0];
      if (op[F_KIND] == kConv) {
        if (op[F_BN] == 32) {
          conv_tile<X, S, 32>(a, op, lt, smem);
        } else {
          conv_tile<X, S, 64>(a, op, lt, smem);
        }
      } else {
        elementwise_tile<X, S>(a, op, lt);
      }
    }
    if (p + 1 < a.n_phases || a.timeline != nullptr) {
      grid_barrier(a.barrier, gridDim.x);
      mark_time(a, p + 1);
    }
  }
}

const void* kernel_for(int x_dtype, int state_dtype) {
  if (x_dtype == 0) {
    if (state_dtype == 0) return (const void*)megakernel<float, float>;
    if (state_dtype == 1) {
      return (const void*)megakernel<float, __nv_bfloat16>;
    }
    if (state_dtype == 2) return (const void*)megakernel<float, E5M2>;
  } else if (x_dtype == 1) {
    if (state_dtype == 0) {
      return (const void*)megakernel<__nv_bfloat16, float>;
    }
    if (state_dtype == 1) {
      return (const void*)megakernel<__nv_bfloat16, __nv_bfloat16>;
    }
    if (state_dtype == 2) {
      return (const void*)megakernel<__nv_bfloat16, E5M2>;
    }
  }
  return nullptr;
}

}  // namespace

// C entry points (loaded with ctypes). Type codes: 0 fp32, 1 bf16, 2 fp8
// e5m2 (state only); frame 0 fp32, 1 bf16, 3 uint8. Each returns 0 on
// success, -1 for an unsupported argument, -2 where the device has no
// cooperative launch, else the cudaError_t.

// Blocks of 256 threads that fit an SM at once, and the SM count: their
// product is the largest grid a cooperative launch accepts.
extern "C" int megakernel_occupancy(int x_dtype, int state_dtype,
                                    int* blocks_per_sm, int* sms) {
  const void* fn = kernel_for(x_dtype, state_dtype);
  if (fn == nullptr) return -1;
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (err == cudaSuccess && !coop) return -2;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                        kThreads, 0);
  }
  return static_cast<int>(err);
}

// One frame: a cooperative grid of `grid` blocks on `stream`. A non-null
// `timeline` ([n_phases + 1] uint64) receives the global timer at the
// start and after every phase (one more barrier at the end).
extern "C" int streaming_megakernel_launch(
    const int* ops, const int* phases, int n_phases, const void* weights,
    void* ws, const void* frame, int frame_dtype, float* preds,
    float* scratch, unsigned int* barrier, const void* const* s_in, void* const* s_out,
    int n_slots, int x_dtype, int state_dtype, float c_mem_lif,
    float c_syn_lif, float c_mem_li, float c_syn_li, int grid,
    unsigned long long* timeline, void* stream) {
  const void* fn = kernel_for(x_dtype, state_dtype);
  if (fn == nullptr || n_slots < 0 || n_slots > kMaxSlots || n_phases <= 0 ||
      grid <= 0 || (frame_dtype != 0 && frame_dtype != 1 && frame_dtype != 3)) {
    return -1;
  }
  Args a{};
  a.ops = ops;
  a.phases = phases;
  a.n_phases = n_phases;
  a.weights = weights;
  a.ws = ws;
  a.frame = frame;
  a.frame_dtype = frame_dtype;
  a.preds = preds;
  a.scratch = scratch;
  a.barrier = barrier;
  a.c_mem[0] = c_mem_lif;
  a.c_syn[0] = c_syn_lif;
  a.c_mem[1] = c_mem_li;
  a.c_syn[1] = c_syn_li;
  a.timeline = timeline;
  for (int n = 0; n < n_slots; ++n) {
    a.s_in[n] = s_in[n];
    a.s_out[n] = s_out[n];
  }
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
