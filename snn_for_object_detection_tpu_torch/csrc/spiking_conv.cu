// Fused k x k conv + eval BatchNorm + LIF / LI over T time steps, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `spiking_conv_seq` of
// snn_for_object_detection_tpu/ops/pallas_kernels.py
// (`_spiking_conv_kernel` under `_spiking_conv_seq_impl`'s pallas_call):
//   in:  x[T, N, H, W, Cin] (fp32 or bf16); w as the wrapper hands it:
//        fp32 [Cin][k][k][Cout], rounded to x's type first (k in {1, 3},
//        stride in {1, 2}, zero padding k / 2 along W and pad_h along H:
//        k / 2, or 0 for rows a caller fetched with the zeros outside the
//        map already in them, a rank's block of a map split along H);
//        a, b[Cout] fp32 (the folded eval BatchNorm); v0, i0[N, Ho, Wo,
//        Cout] (fp32, bf16, fp8 e5m2 or e4m3)
//   out: z[T, N, Ho, Wo, Cout] in x's type, vT, iT in the state type
// Per step: the conv summed in fp32, rounded to x's type; y * a + b in
// fp32 (one fused multiply-add, as XLA contracts it), rounded to x's
// type again; then the cell with the state rounded to its storage type
// (spikes for LIF, the fp32 membrane for LI).
//
// What bounds it: operations. A 3 x 3 layer does 2 * 9 * Cin flops per
// output element and step against a few bytes of x, z and state: at fp32
// 2 * MACs / 67 TFLOP/s (JAX's fp32 semantics forbid TF32), in bf16
// 2 * MACs / 989 TFLOP/s on the tensor cores. Both dtypes run on the
// fp32 lanes here, so bf16 cannot come near its bound (Known limits).
//
// Design. The TPU kernel pre-gathered halo slabs and pre-split stride-2
// phases in HBM for Mosaic and walked t as the innermost grid axis with
// (v, i) in VMEM scratch. Here a CTA owns one image, a tile of output
// pixels and a tile of output channels, and runs the whole time loop in
// blocks of kTB = 4 steps: the convs of a block's steps do not depend on
// each other, so a block is one product of M = pixels x 4 steps rows,
// and only the cell runs step by step. A thread owns the 4 steps of one
// pixel x 8 channels and keeps their (v, i) in fp32 registers from
// t = 0 to T - 1. The launch plan (ops/cuda_kernels.py,
// spiking_conv_plan) picks the tiles, the threads and the chunk.
//
// The CTA's weights sit in shared memory as [c][tap][co]: once for the
// whole time loop where they fit (147,456 bytes at Cin = 128 and a
// 32-channel tile), else streamed with each chunk of input channels,
// once a block of 4 steps. Per block and chunk the halo tile's rows
// (pixel, step) are copied as they lie in device memory (16-, 8- or
// 4-byte cp.async, neighbouring threads neighbouring bytes; the stem's
// Cin = 2 stages 2 channels, not a zero-filled chunk), in flight while
// the chunk before is summed, then transposed once in shared memory
// into fp32 planes [c][pixel][step], stride-2 columns split by phase so
// that neighbouring output pixels read neighbouring words. Per (input
// channel, tap) a thread loads its pixel's 4 steps (16 bytes) and 8
// weights (32 bytes) for 32 FMAs. Every output sums in the order of the
// kernel before this design, input channel, then dy, then dx, with
// __fmaf_rn under --fmad=false, whatever the plan: bit-equal to it, and
// at fp32 to cuDNN's fp32 conv on the GEN1 net (PERF.md).
//
// The epilogue does the roundings, the affine and the shared cell update
// (cell_math.cuh) for the 4 steps in order and writes z[t] once; vT, iT
// are written once at the end. The conv output never goes to device
// memory. The CTAs of one pixel tile (its channel tiles) are neighbours
// in the grid, so they read the same input lines from L2. The entry
// point refuses a plan whose grid or shared memory is not its geometry's.
//
// The fetched-rows form (pad_h = 0) is the same kernel on a block of a
// map split along H: given the rows its output rows read, the halo and
// the zero rows beyond the map's edge in place, a CTA stages the values
// the whole-map launch stages for those outputs, at the same places of
// its planes, so each output's sums are the whole map's bit for bit.
//
// Known limits (PERF.md): the FFMA loop reaches 8-49% of the fp32 bound,
// and neither fewer shared loads a FMA nor a register double buffer of
// the next tap's loads moved it; the deep maps (15 x 19, 8 x 10) give
// few CTAs; the last block of a T that is no multiple of 4 computes
// empty steps. bf16 on the tensor cores in the TPU kernel's tap-major
// order (mma.sync, 4-12x faster) moved the untrained GEN1 net's spikes
// past chip_smoke.py [7]'s 0.99 agreement gate against the plain
// version, which sums in this order, and is not in this source.

#include "cell_math.cuh"

namespace {

using cell_math::E4M3;
using cell_math::E5M2;
using cell_math::from_f32;
using cell_math::round_to;
using cell_math::to_f32;

constexpr int kTB = 4;            // steps a block: rows of the product
constexpr int kMaxThreads = 256;  // threads a CTA at most
constexpr int kMaxSmem = 232448;  // 227 KB: the most a CTA can have

struct Args {
  const void* x;
  const void* w;
  const float* a;
  const float* b;
  const void* v0;
  const void* i0;
  void* z;
  void* vT;
  void* iT;
  int T, N, H, W, Cin, Ho, Wo, Cout, stride;
  int pad_h;  // zero rows above the map (k / 2, or 0 for fetched rows)
  float c_mem, c_syn;
  bool vec;  // Cout % 8 == 0 and z, v0, i0, vT, iT 16-byte aligned
  int xvb;   // staging: bytes a copy of x (16, 8, 4; 0: a value)
  bool wvec;  // weights in 16-byte copies (Cout % 4 == 0)
};

// A launch plan (ops/cuda_kernels.py, ConvPlan)
struct Plan {
  int resident; // weights staged once (1) or with each chunk (0)
  int co;       // output channels a CTA
  int th, tw;   // output pixels a CTA: th rows x tw columns
  int threads;
  int kc;       // input channels a staged chunk
  int smem;     // bytes of dynamic shared memory
  long long grid;
};

// Staging geometry: the halo tile (hin x win pixels; for 1 x 1 the
// tile itself, its input pixels a stride apart) and a plane of it, one
// input channel of 4 steps, in 4-byte words padded to 4 mod 32 so that
// 8 channels x 4 steps written by a warp fall on 32 banks.
struct Geo {
  int hin, win, hw2, npix, plane;
};

inline __host__ __device__ Geo conv_geo(int k, int stride, int th, int tw) {
  Geo g;
  g.hin = k == 3 ? (th - 1) * stride + 3 : th;
  g.win = k == 3 ? (tw - 1) * stride + 3 : tw;
  g.hw2 = (g.win + 1) / 2;
  g.npix = g.hin * g.win;
  g.plane = g.npix * kTB;
  g.plane += (36 - g.plane % 32) % 32;
  return g;
}

// bytes of a staged row (one pixel and step, kc input channels of x's
// type, padded by 16 bytes so that neighbouring rows fall on other banks)
inline __host__ __device__ int conv_row_bytes(int kc, int x_bytes) {
  return (kc * x_bytes + 15) / 16 * 16 + 16;
}

// Shared memory: resident weights [Cin][tap][co] (or two buffers of
// a chunk's [kc][tap][co]), the raw rows of a chunk as they lie in device
// memory, and the chunk as fp32 planes
inline long long conv_smem(int k, int stride, int cin, int x_bytes,
                           const Plan& q) {
  const Geo g = conv_geo(k, stride, q.th, q.tw);
  const long long wk = static_cast<long long>(k) * k * q.co;
  return 4LL * (q.resident ? cin : 2 * q.kc) * wk +
         static_cast<long long>(g.npix) * kTB *
             conv_row_bytes(q.kc, x_bytes) +
         4LL * q.kc * g.plane;
}

inline long long grid_of(const Args& p, const Plan& q) {
  const long long co_tiles = (p.Cout + q.co - 1) / q.co;
  const long long tiles = static_cast<long long>((p.Ho + q.th - 1) / q.th) *
                          ((p.Wo + q.tw - 1) / q.tw);
  return p.N * tiles * co_tiles;
}

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T a[4];
};

// 8 consecutive values (the first nvalid; zeros after)
template <typename T>
__device__ __forceinline__ void load8(const T* src, float (&out)[8],
                                      int nvalid, bool vec) {
  if (vec && nvalid == 8) {
    const Vec4<T> lo = *reinterpret_cast<const Vec4<T>*>(src);
    const Vec4<T> hi = *reinterpret_cast<const Vec4<T>*>(src + 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      out[q] = to_f32(lo.a[q]);
      out[q + 4] = to_f32(hi.a[q]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) out[q] = q < nvalid ? to_f32(src[q]) : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&val)[8],
                                       int nvalid, bool vec) {
  if (vec && nvalid == 8) {
    Vec4<T> lo, hi;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo.a[q] = from_f32<T>(val[q]);
      hi.a[q] = from_f32<T>(val[q + 4]);
    }
    *reinterpret_cast<Vec4<T>*>(dst) = lo;
    *reinterpret_cast<Vec4<T>*>(dst + 4) = hi;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q < nvalid) dst[q] = from_f32<T>(val[q]);
    }
  }
}

// cp.async: `bytes` from global to shared memory, zero-filled where
// `valid` is false (src-size 0), through L1 (.ca)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four consecutive values of x's type in shared memory (8-byte aligned
// at least), widened to fp32
__device__ __forceinline__ void load4_shared(const float* p, float* v) {
  const float2 lo = *reinterpret_cast<const float2*>(p);
  const float2 hi = *reinterpret_cast<const float2*>(p + 2);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}
__device__ __forceinline__ void load4_shared(const __nv_bfloat16* p,
                                             float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// The CTA's place: its image, the first output row and column of its
// pixel tile and its channel tile (channel tiles fastest).
struct Place {
  int n, oy0, ox0, cot;
};

__device__ __forceinline__ Place place_of(const Args& p, const Plan& q) {
  const int co_tiles = (p.Cout + q.co - 1) / q.co;
  const int tiles_w = (p.Wo + q.tw - 1) / q.tw;
  const int tiles = ((p.Ho + q.th - 1) / q.th) * tiles_w;
  int bid = blockIdx.x;
  Place c;
  c.cot = bid % co_tiles;
  bid /= co_tiles;
  const int tile = bid % tiles;
  c.n = bid / tiles;
  c.oy0 = (tile / tiles_w) * q.th;
  c.ox0 = (tile % tiles_w) * q.tw;
  return c;
}

// One step of the epilogue for 8 channels: roundings, affine, cell; the
// state (v, i) is updated and rounded to S, the output returned in out.
template <int CELL, typename X, typename S>
__device__ __forceinline__ void epilogue8(const Args& p, const float* acc,
                                          const float* av, const float* bv,
                                          float* v, float* i, float* out) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float y = round_to<X>(acc[q]);
    y = round_to<X>(__fmaf_rn(y, av[q], bv[q]));
    float vv = v[q], ii = i[q];
    out[q] = cell_math::cell_step<CELL>(y, vv, ii, p.c_mem, p.c_syn);
    v[q] = round_to<S>(vv);
    i[q] = round_to<S>(ii);
  }
}

// A thread owns the 4 steps of one output pixel x 8 channels: tid % CG
// is its channel group (CG = co / 8), tid / CG its pixel in the tile.
template <int CELL, typename X, typename S, int K, int STRIDE>
__global__ void __launch_bounds__(kMaxThreads, 2)
    spiking_conv_kernel(const Args p, const Plan q) {
  constexpr int KK = K * K;
  extern __shared__ __align__(16) float smem[];
  const Geo g = conv_geo(K, STRIDE, q.th, q.tw);
  const int CO = q.co, CG = CO / 8, NT = q.threads, KC = q.kc;
  const int Cin = p.Cin;
  // weights: resident [Cin][tap][CO], or two buffers of a chunk's
  // [KC][tap][CO]; then the raw rows (halo pixel, step) of a chunk and
  // its planes [KC][plane]
  const int wk = KK * CO;  // weights of one input channel
  float* w_s = smem;
  const int rows = g.npix * kTB;
  const int row_bytes = conv_row_bytes(KC, sizeof(X));
  unsigned char* raw = reinterpret_cast<unsigned char*>(
      smem + (q.resident ? Cin : 2 * KC) * wk);
  float* planes = reinterpret_cast<float*>(raw + rows * row_bytes);

  const X* __restrict__ x = static_cast<const X*>(p.x);
  const float* __restrict__ w = static_cast<const float*>(p.w);
  X* __restrict__ z = static_cast<X*>(p.z);

  const int tid = threadIdx.x;
  const int cg = tid % CG, pg = tid / CG;
  const Place c = place_of(p, q);
  const int r = pg / q.tw, qx = pg % q.tw;
  const int oy = c.oy0 + r, ox = c.ox0 + qx;
  const int co = c.cot * CO + cg * 8;
  const int nco = min(8, p.Cout - co);
  const bool mine = oy < p.Ho && ox < p.Wo && nco > 0;
  const int64_t out_off =
      mine ? ((static_cast<int64_t>(c.n) * p.Ho + oy) * p.Wo + ox) * p.Cout +
                 co
           : 0;
  const int64_t slab = static_cast<int64_t>(p.N) * p.Ho * p.Wo * p.Cout;

  // weights [c][tap][Cout] in device memory (the wrapper's fp32 copy,
  // permuted) -> [c][tap][CO] in shared memory, input channels c0 .. c0
  // + kc - 1 of the CTA's channel tile; 16 bytes a copy where they allow
  auto stage_weights = [&](float* dst, int c0, int kc) {
    const float* src0 = w + static_cast<int64_t>(c0) * wk / CO * p.Cout;
    if (p.wvec) {
      const int sh = __ffs(CO / 4) - 1;  // CO / 4 pieces a row
      for (int e = tid; e < kc * wk / 4; e += NT) {
        const int wrow = e >> sh, piece = e & (CO / 4 - 1);
        const int oc = c.cot * CO + piece * 4;
        const bool ok = oc < p.Cout;
        cp_async16(dst + wrow * CO + piece * 4,
                   ok ? src0 + static_cast<int64_t>(wrow) * p.Cout + oc : w,
                   ok);
      }
    } else {
      for (int e = tid; e < kc * wk; e += NT) {
        const int wrow = e / CO, col = e - wrow * CO;
        const int oc = c.cot * CO + col;
        dst[e] = oc < p.Cout ? src0[static_cast<int64_t>(wrow) * p.Cout + oc]
                             : 0.0f;
      }
    }
  };
  if (q.resident) stage_weights(w_s, 0, Cin);  // once

  float av[8], bv[8], v[8], i[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    av[k] = k < nco ? p.a[co + k] : 0.0f;
    bv[k] = k < nco ? p.b[co + k] : 0.0f;
  }
  if (mine) {
    load8(static_cast<const S*>(p.v0) + out_off, v, nco, p.vec);
    load8(static_cast<const S*>(p.i0) + out_off, i, nco, p.vec);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = i[k] = 0.0f;
  }

  const int nblk = (p.T + kTB - 1) / kTB;
  const int nchunk = (Cin + KC - 1) / KC;
  const int items = nblk * nchunk;
  // staging: pieces of p.xvb bytes (16, 8 or 4; 0: one value at a time,
  // synchronously) of each row, neighbouring threads neighbouring pieces,
  // copied as they lie in device memory into the raw rows of a stage
  const int ve = p.xvb ? p.xvb / static_cast<int>(sizeof(X)) : 1;
  auto stage = [&](int j) {
    unsigned char* st = raw;
    const int blk = j / nchunk;
    const int c0 = (j - blk * nchunk) * KC;
    const int kc = min(KC, Cin - c0);
    const int pieces = (kc + ve - 1) / ve;
    for (int e = tid; e < rows * pieces; e += NT) {
      const int row = e / pieces, piece = e - row * pieces;
      const int pix = row / kTB, t = blk * kTB + row % kTB;
      const int hr = pix / g.win, pos = pix - hr * g.win;
      int iy, ix;
      bool ok;
      if (K == 3) {
        const int cc = STRIDE == 2
                           ? (pos < g.hw2 ? 2 * pos : 2 * (pos - g.hw2) + 1)
                           : pos;
        iy = c.oy0 * STRIDE - p.pad_h + hr;
        ix = c.ox0 * STRIDE - 1 + cc;
        ok = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      } else {
        iy = (c.oy0 + hr) * p.stride;
        ix = (c.ox0 + pos) * p.stride;
        ok = c.oy0 + hr < p.Ho && c.ox0 + pos < p.Wo;
      }
      ok = ok && t < p.T;
      const X* src =
          ok ? x + ((static_cast<int64_t>(t) * p.N + c.n) * p.H + iy) *
                       static_cast<int64_t>(p.W) * Cin +
                   static_cast<int64_t>(ix) * Cin + c0 + piece * ve
             : x;
      unsigned char* dst = st + row * row_bytes + piece * ve * sizeof(X);
      if (p.xvb == 16) {
        cp_async16(dst, src, ok);
      } else if (p.xvb == 8) {
        cp_async8(dst, src, ok);
      } else if (p.xvb == 4) {
        cp_async4(dst, src, ok);
      } else {
        *reinterpret_cast<X*>(dst) = ok ? *src : from_f32<X>(0.0f);
      }
    }
    if (!q.resident) stage_weights(w_s + (j % 2) * KC * wk, c0, kc);
  };
  // the raw rows of stage j as planes [c][pixel][step] of fp32, 4 values
  // of a row a time, neighbouring threads neighbouring rows
  auto transpose = [&](int j) {
    const unsigned char* st = raw;
    const int c0 = (j % nchunk) * KC;
    const int kc = min(KC, Cin - c0);
    for (int e = tid; e < rows * ((kc + 3) / 4); e += NT) {
      const int g4 = e / rows, row = e - g4 * rows;
      float val[4];
      load4_shared(reinterpret_cast<const X*>(st + row * row_bytes) + 4 * g4,
                   val);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * g4 + k < kc) planes[(4 * g4 + k) * g.plane + row] = val[k];
      }
    }
  };

  // this thread's pixel in a plane (tap (0, 0)), in words
  const int base = (K == 3 ? r * STRIDE * g.win + qx : r * g.win + qx) * kTB;
  float acc[kTB][8];
#pragma unroll
  for (int tb = 0; tb < kTB; ++tb) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[tb][k] = 0.0f;
  }

  stage(0);
  cp_async_commit();
  for (int j = 0; j < items; ++j) {
    cp_async_wait<0>();  // this thread's copies of item j have landed
    __syncthreads();     // everyone's have, and item j - 1 is summed
    transpose(j);
    __syncthreads();  // the planes of item j are in, the raw rows free
    if (j + 1 < items) stage(j + 1);  // in flight while item j is summed
    cp_async_commit();
    const int blk = j / nchunk;
    const int c0 = (j - blk * nchunk) * KC;
    const int kc = min(KC, Cin - c0);
    const float* in = planes + base;
    const float* wc =
        (q.resident ? w_s + c0 * wk : w_s + (j % 2) * KC * wk) + cg * 8;
#pragma unroll 2
    for (int ci = 0; ci < kc; ++ci) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const int off =
              K == 3 ? dy * g.win +
                           (STRIDE == 2 ? (dx & 1) * g.hw2 + (dx >> 1) : dx)
                     : 0;
          const float4 xv = *reinterpret_cast<const float4*>(in + off * kTB);
          const float* wt = wc + (dy * K + dx) * CO;
          const float4 w0 = *reinterpret_cast<const float4*>(wt);
          const float4 w1 = *reinterpret_cast<const float4*>(wt + 4);
          const float xs[kTB] = {xv.x, xv.y, xv.z, xv.w};
          const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int tb = 0; tb < kTB; ++tb) {
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              acc[tb][k] = __fmaf_rn(xs[tb], ws[k], acc[tb][k]);
            }
          }
        }
      }
      in += g.plane;
      wc += wk;
    }
    if (c0 + kc < Cin) continue;
    // the block's convs are summed: its cells in step order
#pragma unroll
    for (int tb = 0; tb < kTB; ++tb) {
      const int t = blk * kTB + tb;
      if (t < p.T) {
        float out[8];
        epilogue8<CELL, X, S>(p, acc[tb], av, bv, v, i, out);
        if (mine) store8(z + t * slab + out_off, out, nco, p.vec);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[tb][k] = 0.0f;
    }
  }
  if (mine) {
    store8(static_cast<S*>(p.vT) + out_off, v, nco, p.vec);
    store8(static_cast<S*>(p.iT) + out_off, i, nco, p.vec);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the plan's geometry against the arguments: its grid and its shared
// memory
bool plan_ok(const Args& p, int k, int x_dtype, const Plan& q) {
  return q.threads >= 32 && q.threads <= kMaxThreads &&
         q.threads % 32 == 0 && q.th >= 1 && q.tw >= 1 && q.kc >= 1 &&
         q.smem <= kMaxSmem && q.grid == grid_of(p, q) &&
         q.grid <= 0x7fffffff && q.co >= 8 && q.co % 8 == 0 &&
         (q.resident == 0 || q.resident == 1) &&
         q.threads == (q.co / 8) * q.th * q.tw &&
         q.smem == conv_smem(k, p.stride, p.Cin, x_dtype == 0 ? 4 : 2, q);
}
template <typename KernelT>
int launch_kernel(KernelT kernel, const Args& p, const Plan& q,
                  cudaStream_t stream) {
  if (q.grid == 0) return 0;
  if (q.smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(q.grid), q.threads, q.smem, stream>>>(p, q);
  return static_cast<int>(cudaGetLastError());
}

template <int CELL, typename X, typename S>
int launch_geometry(int k, const Args& p, const Plan& q, cudaStream_t s) {
  if (k == 1) {
    return launch_kernel(spiking_conv_kernel<CELL, X, S, 1, 1>, p, q, s);
  }
  if (k == 3 && p.stride == 1) {
    return launch_kernel(spiking_conv_kernel<CELL, X, S, 3, 1>, p, q, s);
  }
  if (k == 3 && p.stride == 2) {
    return launch_kernel(spiking_conv_kernel<CELL, X, S, 3, 2>, p, q, s);
  }
  return -1;
}

template <int CELL, typename X>
int launch_state(int state_dtype, int k, const Args& p, const Plan& q,
                 cudaStream_t s) {
  switch (state_dtype) {
    case 0:
      return launch_geometry<CELL, X, float>(k, p, q, s);
    case 1:
      return launch_geometry<CELL, X, __nv_bfloat16>(k, p, q, s);
    case 2:
      return launch_geometry<CELL, X, E5M2>(k, p, q, s);
    case 3:
      return launch_geometry<CELL, X, E4M3>(k, p, q, s);
  }
  return -1;
}

template <int CELL>
int launch_x(int x_dtype, int state_dtype, int k, const Args& p,
             const Plan& q, cudaStream_t s) {
  switch (x_dtype) {
    case 0:
      return launch_state<CELL, float>(state_dtype, k, p, q, s);
    case 1:
      return launch_state<CELL, __nv_bfloat16>(state_dtype, k, p, q, s);
  }
  return -1;
}

bool fits_int(long long v) { return v >= 0 && v <= 0x7fffffff; }

}  // namespace

// C entry point (loaded with ctypes). Type codes: 0 fp32, 1 bf16, 2 fp8
// e5m2, 3 fp8 e4m3 (state only); cell 0 = LIF, 1 = LI; pad_h the zero
// rows above and below the map (k / 2, or 0 for rows fetched with their
// zeros); the plan's fields as ops/cuda_kernels.py's ConvPlan. Returns 0
// on success, -1 for an unsupported argument, an output size that is not
// the rows' and columns' or a plan that is not its geometry's, else the
// cudaError_t of the launch. Shapes are checked by the Python wrapper.
extern "C" int spiking_conv_seq_launch(
    const void* x, const void* w, const float* a, const float* b,
    const void* v0, const void* i0, void* z, void* vT, void* iT, int T,
    int N, int H, int W, int Cin, int Ho, int Wo, int Cout, int k,
    int stride, int pad_h, int resident, int co, int th, int tw,
    int threads, int kc, int smem, long long grid, int cell, int x_dtype,
    int state_dtype, float c_mem, float c_syn, void* stream) {
  if (T < 0 || N < 0 || Cin <= 0 || Cout <= 0 ||
      (stride != 1 && stride != 2) || (k != 1 && k != 3) ||
      (pad_h != 0 && pad_h != k / 2) || H + 2 * pad_h < k ||
      Ho != (H + 2 * pad_h - k) / stride + 1 ||
      Wo != (W + 2 * (k / 2) - k) / stride + 1 ||
      !fits_int(static_cast<long long>(H) * W * Cin) ||
      !fits_int(static_cast<long long>(Cin) * k * k * Cout)) {
    return -1;
  }
  Args p{x, w, a, b, v0, i0, z, vT, iT, T, N, H, W, Cin, Ho, Wo, Cout,
         stride, pad_h, c_mem, c_syn, false, 0, false};
  p.vec = Cout % 8 == 0 && aligned16(z) && aligned16(v0) && aligned16(i0) &&
          aligned16(vT) && aligned16(iT);
  const Plan q{resident, co, th, tw, threads, kc, smem, grid};
  p.wvec = Cout % 4 == 0 && aligned16(w);
  // the widest copy that divides a pixel's channels, a chunk and x's base
  const int xb = x_dtype == 0 ? 4 : 2;
  for (int vb = 16; vb >= 4 && p.xvb == 0; vb /= 2) {
    if ((Cin * xb) % vb == 0 && (kc * xb) % vb == 0 &&
        reinterpret_cast<uintptr_t>(x) % vb == 0) {
      p.xvb = vb;
    }
  }
  if (!plan_ok(p, k, x_dtype, q)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cell == cell_math::kLIF) {
    return launch_x<cell_math::kLIF>(x_dtype, state_dtype, k, p, q, s);
  }
  if (cell == cell_math::kLI) {
    return launch_x<cell_math::kLI>(x_dtype, state_dtype, k, p, q, s);
  }
  return -1;
}
