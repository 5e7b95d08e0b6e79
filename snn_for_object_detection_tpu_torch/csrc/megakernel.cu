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
// output, activations, pool sums and residual sums round to X. The conv
// sums in another order than the plain version, and tanhf / expf are not
// XLA's, so the two agree to spike agreement, not bit for bit; the
// witness (ops/megakernel.py, run_distance) holds both against conv sums
// taken in float64.
//
// What bounds it: operations. A GEN1 TinyYolo frame is 3.81 G
// multiply-adds (48 convs) against 17 MB of fp32 weights and 42 MB of
// fp32 state read and written once: at 67 TFLOP/s fp32 the math alone
// takes 0.11 ms, the bytes 0.03 ms. What it took instead (PERF.md): one
// grid barrier per phase of the op table, phases that move a few
// elements, a workspace far larger than L2, and conv tiles that wait on
// their staging loads.
//
// Design. On the TPU everything sat in VMEM for the frame; a Hopper SM
// has 227 KB of shared memory, so weights, states and activations live
// in device memory, mostly in the 50 MB L2. What the kernel keeps of the
// TPU kernel is one program per frame with no host round trip between
// layers:
//   - one cooperative launch (all blocks co-resident: two blocks of 256
//     threads an SM) walks the phases of the op table; ops of one phase
//     are independent (their inputs were written in earlier phases), and
//     the blocks take their tiles in a grid-stride loop; a grid-wide
//     barrier (a sense-reversing counter in device memory with
//     __threadfence) separates phases. Only convs, and the Pool / Up
//     layers of other models, make phases: a Residual sum runs in the
//     epilogue of the conv that makes one branch, and a Dense
//     concatenation is written in place (each branch's producer writes
//     its channels of the wider buffer, readers gather with a row stride
//     and channel offset), so TinyYolo GEN1 runs its 48 convs in 36
//     phases, the depth of their dependencies. The host gives buffers
//     whose live phases do not overlap the same memory, so a frame's
//     live activations (14 MB at fp32) stay in L2;
//   - a conv is an implicit GEMM over M = Ho*Wo pixels, N = Cout, K =
//     k*k*Cin in (tap, channel) order: a block computes a 64 x 64 (or,
//     for Cout <= 32, 128 x 32) output tile with a 4 x 4 fp32 register
//     tile a thread. K-chunks of 16 go through a 3-stage ring in shared
//     memory filled by cp.async: where Cin % 16 == 0 a chunk is 16
//     consecutive channels of one tap, one 16-byte-aligned run per pixel
//     in NHWC, copied 16 bytes at a time with zero fill for the padding;
//     other convs (the stage-1 downsample, Cin = 2) stage value by value.
//     One block barrier a chunk. fp32 runs on FFMA, every output summed
//     k ascending (TF32 would change JAX's fp32 results); bf16 runs on
//     the tensor cores (mma.sync m16n8k16, fp32 sums; each warp a 32 x 16
//     block, fragments from the staged chunk with ldmatrix), which sums
//     in another order and is held by the witness as well as the
//     agreement gates of chip_smoke.py [8]. The Norm, the LIF / LI
//     update, a following activation and a Residual sum run in its
//     epilogue, which issues every load before it uses one;
//   - a conv whose tiles fill less than half the grid (the 60x76 and
//     deeper layers: 4-252 tiles for 264 blocks) is split along K into up
//     to 16 slices of whole chunks: each slice writes its fp32 partial
//     sums to scratch, fences and arrives on its tile's counter, and the
//     slice that arrives last sums the slices in order from 0 and runs
//     the epilogue in the same phase (no atomics on values, so the
//     result is deterministic), then resets the counter; the FFMA path
//     sums exactly as the separate reduce phase of the kernel before
//     this design did, bit for bit;
//   - reads of data written during the launch bypass L1 (ld.global.cg,
//     cp.async.cg), since L1 is not coherent across SMs; buffers are
//     128-byte aligned.
// Known limits (PERF.md): fp32 on FFMA; one grid barrier per phase,
// about 4.5 us at 264 blocks, and deep phases of a few tiles that are
// latency chains (staging, counter, the last slice's sum, the state);
// mma.sync rather than wgmma; the epilogue stores one value at a time.

#include <type_traits>

#include "cell_math.cuh"

namespace {

using cell_math::E4M3;
using cell_math::E5M2;
using cell_math::from_f32;
using cell_math::kLI;
using cell_math::kLIF;
using cell_math::round_to;
using cell_math::to_f32;

// op table fields (ops/cuda_kernels.py, MK_FIELDS)
enum Field {
  F_KIND, F_SRC_SPACE, F_SRC_OFF, F_SRC_C, F_SRC_CH_OFF, F_RES_SPACE,
  F_RES_OFF, F_RES_C, F_RES_CH_OFF, F_DST_SPACE, F_DST_OFF, F_DST_C,
  F_CH_OFF, F_H, F_W, F_CIN, F_HO, F_WO, F_COUT, F_K, F_STRIDE, F_W_OFF,
  F_NK_OFF, F_NB_OFF, F_CELL, F_SLOT_V, F_SLOT_I, F_ACT, F_POOL, F_TILES,
  F_TILE0, F_BN, F_SPLIT, F_SCRATCH_OFF, F_COUNTER_OFF, F_VEC_A, F_VEC_B,
};
constexpr int kRow = 40;
enum Kind { kConv = 0, kEw, kPool, kUp, kAdd, kCopy };
enum Space { kWs = 0, kFrame, kPreds };
enum Act { kNoAct = 0, kRelu, kSilu, kTanh };
enum Pool { kMax = 0, kMean, kSum };

constexpr int kThreads = 256;
constexpr int kMaxSlots = 128;
constexpr int kBK = 16;       // K-chunk of a conv tile
constexpr int kStages = 3;    // K-chunks in the cp.async ring
constexpr int kEwTile = 1024; // elements of an elementwise tile
// one ring stage at its largest: 128 pixels x (16 + 4) fp32 of input and
// 16 x 32 fp32 of weights (the 64 x 64 tile needs 9 KB)
constexpr int kStageBytes = 128 * (kBK + 4) * 4 + kBK * 32 * 4;
constexpr int kSmemBytes = kStages * kStageBytes;

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
  unsigned int* counters;  // slices arrived, per output tile of a split conv
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

// four consecutive values of X in shared memory, widened to fp32
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// 16 bytes from global to shared memory, L2 only (data written earlier in
// the launch by other SMs is in L2, not in this SM's L1); zero-filled
// where `valid` is false
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// tensor cores (bf16 only): four 8 x 8 matrices of 16-bit values from
// shared memory, as mma.sync fragments (`TRANS`: each row of the stored
// matrix becomes a column)
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  }
}

// d += a (16 x 16, row-major) * b (16 x 8), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the epilogue chain of a conv or elementwise op: Norm, cell, activation,
// then the Residual sum with the value at `res` (if any)
struct Epi {
  int nk, nb, cell, sv, si, act, res_space;
};

__device__ __forceinline__ Epi epi_of(const int* op) {
  return Epi{op[F_NK_OFF], op[F_NB_OFF], op[F_CELL], op[F_SLOT_V],
             op[F_SLOT_I], op[F_ACT], op[F_RES_SPACE]};
}

// The epilogue chain on one value y (the conv sum or the op's input),
// given its loaded operands: Norm (k, b), the cell (state v, i, updated
// in place), the activation, the Residual sum with r.
template <typename X>
__device__ __forceinline__ float chain(const Args& a, const Epi& e, float y,
                                       float k, float b, float& v, float& i,
                                       float r) {
  y = round_to<X>(y);
  if (e.nk >= 0) {
    if (std::is_same<X, float>::value) {
      y = __fmaf_rn(y, k, b);
    } else {
      y = __fadd_rn(round_to<X>(__fmul_rn(y, k)), b);
      if (e.cell < 0 && e.act == kNoAct) y = round_to<X>(y);
    }
  }
  if (e.cell >= 0) {
    const float out =
        e.cell == kLIF
            ? cell_math::cell_step<kLIF>(y, v, i, a.c_mem[0], a.c_syn[0])
            : cell_math::cell_step<kLI>(y, v, i, a.c_mem[1], a.c_syn[1]);
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
  if (e.res_space >= 0) y = round_to<X>(__fadd_rn(y, r));
  return y;
}

// The epilogue of one value of channel n, state index sidx, Residual
// input index res_idx.
template <typename X, typename S>
__device__ __forceinline__ float epilogue1(const Args& a, const Epi& e,
                                           float y, int n, int64_t sidx,
                                           int64_t res_idx) {
  float k = 0.0f, b = 0.0f, v = 0.0f, i = 0.0f, r = 0.0f;
  if (e.nk >= 0) {
    k = load_w<X>(a, e.nk + n);
    b = load_w<X>(a, e.nb + n);
  }
  if (e.cell >= 0) {
    v = to_f32(static_cast<const S*>(a.s_in[e.sv])[sidx]);
    i = to_f32(static_cast<const S*>(a.s_in[e.si])[sidx]);
  }
  if (e.res_space >= 0) r = load_act<X>(a, e.res_space, res_idx);
  y = chain<X>(a, e, y, k, b, v, i, r);
  if (e.cell >= 0) {
    static_cast<S*>(a.s_out[e.sv])[sidx] = from_f32<S>(v);
    static_cast<S*>(a.s_out[e.si])[sidx] = from_f32<S>(i);
  }
  return y;
}

// One BM x BN output tile of a conv (implicit GEMM, see the note above),
// or of one K-slice of a split conv. K runs tap by tap, channel by
// channel, in chunks of 16 staged through a ring of kStages buffers.
template <typename X, typename S, int BN>
__device__ __noinline__ void conv_tile(const Args& a, const int* op, int t,
                                       unsigned char* smem) {
  constexpr int BM = 4096 / BN;   // 64 or 128 rows: 4 x 4 a thread
  constexpr int TN = BN / 4;      // threads along N
  constexpr int VEC = 16 / sizeof(X);       // values in 16 bytes
  constexpr int AS = kBK + VEC;   // row stride of the staged input
  constexpr int PA = kBK / VEC;   // 16-byte pieces of a staged input row
  constexpr int PB = BN / VEC;    // 16-byte pieces of a staged weight row
  constexpr int JA = (BM * PA + kThreads - 1) / kThreads;  // pieces/thread
  // bf16 runs on the tensor cores: each warp a 32 x 16 block of the tile
  constexpr bool MMA = std::is_same<X, __nv_bfloat16>::value;
  constexpr int BS = MMA ? BN + 8 : BN;  // staged weight row (ldmatrix:
                                         // 8 rows on 8 bank groups)
  constexpr int WN = BN / 16;            // warps along N
  constexpr int STAGE = BM * AS + kBK * BS;  // values of X a stage
  static_assert(STAGE * sizeof(X) <= kStageBytes, "ring stage too large");
  X* ring = reinterpret_cast<X*>(smem);
  __shared__ int last_slice;

  const int H = op[F_H], W = op[F_W], Cin = op[F_CIN];
  const int Wo = op[F_WO], Cout = op[F_COUT];
  const int k = op[F_K], stride = op[F_STRIDE], pad = k / 2;
  const int M = op[F_HO] * Wo, K = k * k * Cin;
  const int src_space = op[F_SRC_SPACE], src_off = op[F_SRC_OFF];
  const int src_c = op[F_SRC_C], src_ch_off = op[F_SRC_CH_OFF];
  const bool vec_a = op[F_VEC_A] != 0, vec_b = op[F_VEC_B] != 0;
  const X* __restrict__ w = static_cast<const X*>(a.weights) + op[F_W_OFF];
  const X* __restrict__ src = static_cast<const X*>(a.ws) + src_off +
                              src_ch_off;
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
  const int n_chunks = (k_hi - k_lo + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  // the input pixels whose 16-byte pieces this thread stages (vec_a)
  int iy0[JA], ix0[JA];
#pragma unroll
  for (int j = 0; j < JA; ++j) {
    const int m = m0 + (tid + kThreads * j) / PA;
    const bool in = m < M && tid + kThreads * j < BM * PA;
    iy0[j] = in ? (m / Wo) * stride - pad : -0x40000000;  // never inside
    ix0[j] = in ? (m % Wo) * stride - pad : 0;
  }

  // stage the chunk at K offset k0 into ring buffer `s`
  auto stage = [&](int s, int k0) {
    X* As = ring + s * STAGE;  // [BM][AS]: pixel-major, 16 channels a row
    X* Bs = As + BM * AS;      // [kBK][BS]
    if (vec_a) {  // one tap, 16 consecutive channels: one run a pixel
      const int tap = k0 / Cin, ci0 = k0 - tap * Cin;
      const int dy = tap / k, dx = tap - (tap / k) * k;
#pragma unroll
      for (int j = 0; j < JA; ++j) {
        const int p = tid + kThreads * j;
        if (p < BM * PA) {
          const int iy = iy0[j] + dy, ix = ix0[j] + dx;
          const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
          const X* g = in ? src + (static_cast<int64_t>(iy) * W + ix) *
                                      src_c + ci0 + (p % PA) * VEC
                          : src;
          cp_async16(As + (p / PA) * AS + (p % PA) * VEC, g, in);
        }
      }
    } else {  // any Cin and source: one value at a time
      const int kk = tid % kBK, kg = k0 + kk;  // this thread's K row
      const bool kin = kg < K;
      const int tap = kin ? kg / Cin : 0, ci = kg - tap * Cin;
      const int dy = tap / k, dx = tap - (tap / k) * k;
      for (int r = tid / kBK; r < BM; r += kThreads / kBK) {
        const int m = m0 + r;
        float v = 0.0f;
        if (kin && m < M) {
          const int oy = m / Wo;
          const int iy = oy * stride - pad + dy;
          const int ix = (m - oy * Wo) * stride - pad + dx;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
            v = load_act<X>(a, src_space,
                            src_off + (static_cast<int64_t>(iy) * W + ix) *
                                          src_c + src_ch_off + ci);
          }
        }
        As[r * AS + kk] = from_f32<X>(v);
      }
    }
    if (vec_b) {  // 16 rows of Cout weights, BN of them a row
      if (tid < kBK * PB) {
        const int r = tid / PB, n = n0 + (tid % PB) * VEC;
        const bool in = k0 + r < K && n < Cout;
        cp_async16(Bs + r * BS + (tid % PB) * VEC,
                   in ? w + static_cast<int64_t>(k0 + r) * Cout + n : w, in);
      }
    } else {
      for (int e = tid; e < kBK * BN; e += kThreads) {
        const int r = e / BN, n = n0 + e % BN;
        Bs[r * BS + e % BN] = k0 + r < K && n < Cout
                    ? w[static_cast<int64_t>(k0 + r) * Cout + n]
                    : from_f32<X>(0.0f);
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  const int tm = tid / TN, tn = tid % TN;

  __syncthreads();  // the previous tile is done with the ring
  stage(0, k_lo);
  cp_async_commit();
  if (n_chunks > 1) stage(1, k_lo + kBK);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();  // this thread's copies of chunk c have landed
    __syncthreads();     // everyone's have, and chunk c - 1 is consumed
    if (c + 2 < n_chunks) stage((c + 2) % kStages, k_lo + (c + 2) * kBK);
    cp_async_commit();
    const X* As = ring + (c % kStages) * STAGE;
    const X* Bs = As + BM * AS;
    if constexpr (MMA) {  // acc[2 mi + ni] is block (mi, ni)'s fragment
      const int lane = tid % 32, wm = tid / 32 / WN, wn = tid / 32 % WN;
      unsigned af[2][4], bf[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldmatrix_x4<false>(af[mi], As + (wm * 32 + mi * 16 + lane % 16) * AS +
                                       lane / 16 * 8);
      }
      ldmatrix_x4<true>(bf, Bs + (lane % 16) * BS + wn * 16 + lane / 16 * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          mma_bf16(acc[2 * mi + ni], af[mi], bf[2 * ni], bf[2 * ni + 1]);
        }
      }
      continue;
    }
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      float av[4][4], bv[4][4];  // [row][k], [k][col]
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(As + (tm * 4 + i) * AS + kq, av[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        load4(Bs + (kq + kk) * BS + tn * 4, bv[kk]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k ascending for every output
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = __fmaf_rn(av[i][kk], bv[kk][j], acc[i][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (MMA) {
    // the warps' fragments through shared memory into the 4 x 4 a thread
    // layout of the epilogue: value r of block (mi, ni) is row 16 mi +
    // lane / 4 + 8 (r / 2), column 8 ni + 2 (lane % 4) + r % 2 of the
    // warp's 32 x 16 block
    constexpr int TS = BN + 4;
    static_assert(BM * TS * 4 <= kSmemBytes, "tile larger than the ring");
    float* tile = reinterpret_cast<float*>(smem);
    const int lane = tid % 32, wm = tid / 32 / WN, wn = tid / 32 % WN;
    float frag[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int r = 0; r < 4; ++r) frag[b][r] = acc[b][r];
    }
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          tile[(wm * 32 + mi * 16 + lane / 4 + 8 * (r / 2)) * TS + wn * 16 +
               ni * 8 + 2 * (lane % 4) + r % 2] = frag[2 * mi + ni][r];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load4(tile + (tm * 4 + i) * TS + tn * 4, acc[i]);
    }
  }

  // this thread's outputs: rows m0 + tm * 4 + i for i < rows, channels
  // n + j for j < cnt; loads below clamp to them, so that every load of a
  // loop is issued before the first value is used
  const int n = n0 + tn * 4;
  const int cnt = min(4, Cout - n);
  const int rows = max(0, min(4, M - (m0 + tm * 4)));
  const bool any = rows > 0 && cnt > 0;
  int64_t at[4];  // m * Cout + n of each row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    at[i] = static_cast<int64_t>(m0 + tm * 4 + min(i, max(rows - 1, 0))) *
                Cout + n;
  }
  if (split > 1) {
    // this slice's partial sums to scratch; the slice that arrives last
    // at the tile's counter sums all slices in order
    const bool v4 = (Cout & 3) == 0;  // 16-byte rows (scratch is aligned)
    const int64_t plane = static_cast<int64_t>(M) * Cout;
    const float* scratch = a.scratch + op[F_SCRATCH_OFF];
    float* part = a.scratch + op[F_SCRATCH_OFF] + slice * plane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= rows || cnt <= 0) continue;
      if (v4) {
        *reinterpret_cast<float4*>(part + at[i]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        for (int j = 0; j < cnt; ++j) part[at[i] + j] = acc[i][j];
      }
    }
    __threadfence();
    __syncthreads();
    unsigned int* counter = a.counters + op[F_COUNTER_OFF] + t;
    if (tid == 0) {
      last_slice = atomicAdd(counter, 1u) == static_cast<unsigned>(split - 1);
    }
    __syncthreads();
    if (!last_slice) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }
    if (any) {
      // four slices at a time, every load in flight before the sums
      for (int s0 = 0; s0 < split; s0 += 4) {
        float q[4][4][4];  // [slice][row][channel]
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* p = scratch + min(s0 + u, split - 1) * plane;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (v4) {
              const float4 f =
                  __ldcg(reinterpret_cast<const float4*>(p + at[i]));
              q[u][i][0] = f.x;
              q[u][i][1] = f.y;
              q[u][i][2] = f.z;
              q[u][i][3] = f.w;
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                q[u][i][j] = __ldcg(p + at[i] + min(j, cnt - 1));
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (s0 + u >= split) break;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = __fadd_rn(acc[i][j], q[u][i][j]);
            }
          }
        }
      }
    }
    if (tid == 0) *counter = 0u;  // ready for the next frame
  }
  if (!any) return;

  // the epilogue: every operand loaded first, then each value's chain
  const Epi e = epi_of(op);
  float kv[4] = {}, bv[4] = {}, sv[4][4] = {}, si[4][4] = {}, rv[4][4] = {};
  if (e.nk >= 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = load_w<X>(a, e.nk + n + min(j, cnt - 1));
      bv[j] = load_w<X>(a, e.nb + n + min(j, cnt - 1));
    }
  }
  if (e.cell >= 0) {
    const S* v_in = static_cast<const S*>(a.s_in[e.sv]);
    const S* i_in = static_cast<const S*>(a.s_in[e.si]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sv[i][j] = to_f32(v_in[at[i] + min(j, cnt - 1)]);
        si[i][j] = to_f32(i_in[at[i] + min(j, cnt - 1)]);
      }
    }
  }
  if (e.res_space >= 0) {
    const int res_c = op[F_RES_C];
    const int64_t res_off = op[F_RES_OFF] + op[F_RES_CH_OFF] + n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t m = m0 + tm * 4 + min(i, rows - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rv[i][j] = load_act<X>(a, e.res_space,
                               res_off + m * res_c + min(j, cnt - 1));
      }
    }
  }
  const int dst_space = op[F_DST_SPACE], dst_c = op[F_DST_C];
  const int64_t dst_off = op[F_DST_OFF] + op[F_CH_OFF] + n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= rows) break;
    const int64_t m = m0 + tm * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= cnt) break;
      const float y = chain<X>(a, e, acc[i][j], kv[j], bv[j], sv[i][j],
                               si[i][j], rv[i][j]);
      if (e.cell >= 0) {
        static_cast<S*>(a.s_out[e.sv])[at[i] + j] = from_f32<S>(sv[i][j]);
        static_cast<S*>(a.s_out[e.si])[at[i] + j] = from_f32<S>(si[i][j]);
      }
      store_act<X>(a, dst_space, dst_off + m * dst_c + j, y);
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
  const int src_space = op[F_SRC_SPACE];
  const int src_off = op[F_SRC_OFF] + op[F_SRC_CH_OFF], src_c = op[F_SRC_C];
  const int res_off = op[F_RES_OFF] + op[F_RES_CH_OFF], res_c = op[F_RES_C];
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
    const int64_t at = src_off + pix * src_c + c;  // same pixel, channel
    float y;
    if (kind == kEw) {
      y = epilogue1<X, S>(a, e, load_act<X>(a, src_space, at), c, idx,
                          res_off + pix * res_c + c);
    } else if (kind == kAdd) {
      y = round_to<X>(
          __fadd_rn(load_act<X>(a, src_space, at),
                    load_act<X>(a, e.res_space, res_off + pix * res_c + c)));
    } else if (kind == kCopy) {
      y = load_act<X>(a, src_space, at);
    } else {
      const int oy = static_cast<int>(pix / Wo);
      const int ox = static_cast<int>(pix % Wo);
      if (kind == kUp) {
        y = load_act<X>(
            a, src_space,
            src_off + (static_cast<int64_t>(oy / k) * W + ox / k) * src_c +
                c);
      } else {
        const int pool = op[F_POOL];
        float m = 0.0f;
        for (int dy = 0; dy < k; ++dy) {
          for (int dx = 0; dx < k; ++dx) {
            const float v = load_act<X>(
                a, src_space,
                src_off +
                    (static_cast<int64_t>(oy * k + dy) * W + ox * k + dx) *
                        src_c + c);
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
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
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
    if (state_dtype == 3) return (const void*)megakernel<float, E4M3>;
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
    if (state_dtype == 3) {
      return (const void*)megakernel<__nv_bfloat16, E4M3>;
    }
  }
  return nullptr;
}

}  // namespace

// C entry points (loaded with ctypes). Type codes: 0 fp32, 1 bf16, 2 fp8
// e5m2, 3 fp8 e4m3 (state only); frame 0 fp32, 1 bf16, 3 uint8. Each returns 0 on
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
    float* scratch, unsigned int* counters, unsigned int* barrier,
    const void* const* s_in, void* const* s_out,
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
  a.counters = counters;
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
