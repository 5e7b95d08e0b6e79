// Fused k x k conv + eval BatchNorm + LIF / LI over T time steps, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `spiking_conv_seq` of
// snn_for_object_detection_tpu/ops/pallas_kernels.py
// (`_spiking_conv_kernel` under `_spiking_conv_seq_impl`'s pallas_call):
//   in:  x[T, N, H, W, Cin] (fp32 or bf16), w[k, k, Cin, Cout] in x's
//        type (k in {1, 3}, stride in {1, 2}, zero padding k / 2),
//        a, b[Cout] fp32 (the folded eval BatchNorm),
//        v0, i0[N, Ho, Wo, Cout] (fp32, bf16 or fp8 e5m2)
//   out: z[T, N, Ho, Wo, Cout] in x's type, vT, iT in the state type
// Per step: the conv summed in fp32, rounded to x's type; y * a + b in
// fp32 (one fused multiply-add, as XLA contracts it), rounded to x's
// type again; then the cell with the state rounded to its storage type
// (spikes for LIF, the fp32 membrane for LI). (`fused_pointwise_conv_bn_lif`
// has a kernel of its own, pointwise.cu.)
//
// What bounds it: operations. A 3 x 3 layer does 2 * 9 * Cin flops per
// output element and step against a few bytes of x, z and state, far
// above the card's ~20 fp32 flops per byte, so the least time is
// 2 * MACs / 67 TFLOP/s (fp32 outside the tensor cores: JAX's fp32
// semantics forbid TF32; bf16 products are exact in fp32, so both types
// run on the fp32 lanes here).
//
// Design. The TPU kernel pre-gathered halo slabs and pre-split stride-2
// phases in HBM for Mosaic and walked t as the innermost grid axis with
// (v, i) in VMEM scratch. Here one CTA owns one image, a tile of output
// pixels (TH x TW for 3 x 3, TH * TW consecutive pixels for 1 x 1) and
// 32 output channels, and runs the whole time loop:
//   - each thread owns PXT pixels (neighbours on one row) x 4 channels
//     and keeps their (v, i) in fp32 registers from t = 0 to T - 1;
//   - per step and per chunk of input channels (16 for 3 x 3, 32 for
//     1 x 1) it stages the zero-padded input tile (halo included) and
//     the chunk's weights in shared memory, 8 channels of a pixel per
//     vector load, then accumulates in fp32 with explicit __fmaf_rn (the
//     sources build with --fmad=false); a 3 x 3 row of taps reuses one
//     register window of the input row for its three dx taps;
//   - the epilogue does the roundings, the affine and the shared cell
//     update (cell_math.cuh) and writes z[t] once; vT, iT are written
//     once at the end. The conv output never goes to device memory.
// Every output sums its products in the plain conv's order (input
// channel, then dy, then dx), whatever the tile, so every launch plan
// gives the same bits.
//
// Launch plan. The CTA tile is one of two shapes (kTiles), picked per
// layer by ops/cuda_kernels.py::spiking_conv_plan, which passes its
// index and grid; the entry point checks the grid. Tile 0 (8 x 16
// pixels, 4 a thread, 256 threads) fills the card on the large maps;
// the 15 x 19 and 8 x 10 maps of the deep layers, where tile 0 gives
// 16-128 CTAs, take tile 1 (4 x 8 pixels, 2 a thread, 128 threads) for
// 64-384 CTAs. Direct indexing covers stride 2, odd inputs and Cin = 2.
// The CTAs of one pixel tile (its channel tiles) are launched next to
// each other so they read the same input lines from L2. 512 threads an
// SM by registers (128 a thread), up to 54 KB of shared memory a CTA.
//
// Known limits (PERF.md): FFMA only, so bf16 runs at the fp32 rate far
// from its tensor-core bound: a tensor-core MMA sums in another order,
// which the fused path's spike-agreement gate refuses on its untrained
// net (PERF.md, Findings); every chunk of every step stages the CTA's
// weights again, a cost that a smaller pixel tile does not shrink, so
// on the deep layers tile 1 is at most 1.6x faster than tile 0 (H100,
// PERF.md); each output fragment costs a 16-byte shared load of weights
// per tap; the stem's Cin = 2 fills a chunk of 16 with zeros.

#include "cell_math.cuh"

namespace {

using cell_math::E5M2;
using cell_math::from_f32;
using cell_math::round_to;
using cell_math::to_f32;

constexpr int kCo = 32;             // output channels a CTA
constexpr int kChGroups = kCo / 4;  // 4 channels a thread
constexpr int kSmThreads = 512;     // threads an SM, by registers

// The CTA tiles of the launch plan: {TH, TW, PXT} (pixel rows, pixel
// columns, pixels a thread); the plan passes the index.
constexpr int kTiles[2][3] = {{8, 16, 4}, {4, 8, 2}};

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
  float c_mem, c_syn;
  bool vec4;  // Cout % 4 == 0 and w, v0, i0, z, vT, iT 16-byte aligned
  bool xvec;  // Cin % 8 == 0 and x 16-byte aligned
};

// Shared-memory geometry of one instance. A chunk of KC input channels
// is staged as KC planes of the (halo) tile; a plane holds PLANE floats,
// padded so that the 8 planes one thread writes fall on other banks
// than its neighbours' (PLANE % 4 == 2 for 3 x 3; 1 x 1 keeps PLANE a
// multiple of 4 for its 16-byte reads).
template <int K, int STRIDE, int TH, int TW>
struct Tile {
  static constexpr bool kRect = K == 3;
  static constexpr int KC = kRect ? 16 : 32;
  static constexpr int HIN = kRect ? (TH - 1) * STRIDE + K : 1;
  static constexpr int WIN = kRect ? (TW - 1) * STRIDE + K : TH * TW;
  static constexpr int NPIX = HIN * WIN;
  static constexpr int PLANE = kRect ? NPIX + (6 - NPIX % 4) % 4 : NPIX;
  static constexpr int IN_FLOATS = KC * PLANE;
  static constexpr int W_FLOATS = K * K * KC * kCo;
  static constexpr int BYTES = 4 * (IN_FLOATS + W_FLOATS);
};

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T a[4];
};

template <typename T>
__device__ __forceinline__ void load4(const T* src, float (&out)[4],
                                      int nvalid, bool vec) {
  if (vec && nvalid == 4) {
    const Vec4<T> v = *reinterpret_cast<const Vec4<T>*>(src);
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = to_f32(v.a[q]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = q < nvalid ? to_f32(src[q]) : 0.0f;
  }
}

// 8 consecutive values from src (the first nvalid; zeros after)
template <typename T>
__device__ __forceinline__ void load8(const T* src, float (&out)[8],
                                      int nvalid, bool vec) {
  if (vec && nvalid >= 8) {
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
__device__ __forceinline__ void store4(T* dst, const float (&val)[4],
                                       int nvalid, bool vec) {
  if (vec && nvalid == 4) {
    Vec4<T> v;
#pragma unroll
    for (int q = 0; q < 4; ++q) v.a[q] = from_f32<T>(val[q]);
    *reinterpret_cast<Vec4<T>*>(dst) = v;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < nvalid) dst[q] = from_f32<T>(val[q]);
    }
  }
}

// K = 3: rectangular TH x TW pixel tiles with a halo, STRIDE in {1, 2}.
// K = 1: TH * TW consecutive output pixels, each reading one input
// pixel; the stride is a run-time argument there (STRIDE is unused).
// A thread owns PXT neighbouring pixels of a row x 4 channels.
template <int CELL, typename X, typename S, int K, int STRIDE, int TH,
          int TW, int PXT>
__global__ void __launch_bounds__(TH * TW / PXT * kChGroups,
                                  kSmThreads / (TH * TW / PXT * kChGroups))
    spiking_conv_kernel(const Args p) {
  using G = Tile<K, STRIDE, TH, TW>;
  constexpr bool kRect = G::kRect;
  constexpr int KC = G::KC;  // input channels a chunk
  constexpr int WIN = G::WIN;
  constexpr int PLANE = G::PLANE;
  constexpr int NT = TH * TW / PXT * kChGroups;  // threads
  constexpr int TP = TH * TW;       // pixels a CTA
  constexpr int GPR = TW / PXT;     // pixel groups of a tile row
  constexpr int WINDOW = (PXT - 1) * STRIDE + K;  // inputs of a tap row
  static_assert(TW % PXT == 0 && NT % TP == 0 && (PXT == 4 || PXT == 2),
                "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem;                  // [c][y][x]
  float* w_s = smem + G::IN_FLOATS;    // [tap][c][co]

  const X* __restrict__ x = static_cast<const X*>(p.x);
  const X* __restrict__ w = static_cast<const X*>(p.w);
  X* __restrict__ z = static_cast<X*>(p.z);

  const int tid = threadIdx.x;
  const int cg = tid % kChGroups;
  const int pg = tid / kChGroups;

  // block -> (image, pixel tile, channel tile), channel tile fastest
  const int co_tiles = (p.Cout + kCo - 1) / kCo;
  const int tiles_w = (p.Wo + TW - 1) / TW;
  const int tiles = kRect ? ((p.Ho + TH - 1) / TH) * tiles_w
                          : (p.Ho * p.Wo + TP - 1) / TP;
  int bid = blockIdx.x;
  const int cot = bid % co_tiles;
  bid /= co_tiles;
  const int tile = bid % tiles;
  const int n = bid / tiles;
  const int oy0 = kRect ? (tile / tiles_w) * TH : 0;
  const int ox0 = kRect ? (tile % tiles_w) * TW : 0;
  const int co = cot * kCo + cg * 4;  // this thread's first channel
  const int nco = min(4, p.Cout - co);

  // this thread's PXT output pixels: offsets into one time slab, -1 if
  // out
  int64_t out_off[PXT];
#pragma unroll
  for (int j = 0; j < PXT; ++j) {
    int oy, ox;
    bool ok;
    if (kRect) {
      oy = oy0 + pg / GPR;
      ox = ox0 + (pg % GPR) * PXT + j;
      ok = oy < p.Ho && ox < p.Wo;
    } else {
      const int q = tile * TP + pg * PXT + j;
      oy = q / p.Wo;
      ox = q % p.Wo;
      ok = q < p.Ho * p.Wo;
    }
    out_off[j] = ok && nco > 0
                     ? ((static_cast<int64_t>(n) * p.Ho + oy) * p.Wo + ox) *
                               p.Cout + co
                     : -1;
  }

  float av[4], bv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    av[q] = q < nco ? p.a[co + q] : 0.0f;
    bv[q] = q < nco ? p.b[co + q] : 0.0f;
  }
  float v[PXT][4], i[PXT][4];
#pragma unroll
  for (int j = 0; j < PXT; ++j) {
    if (out_off[j] >= 0) {
      load4(static_cast<const S*>(p.v0) + out_off[j], v[j], nco, p.vec4);
      load4(static_cast<const S*>(p.i0) + out_off[j], i[j], nco, p.vec4);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[j][q] = i[j][q] = 0.0f;
    }
  }

  const int64_t frame = static_cast<int64_t>(p.H) * p.W * p.Cin;
  const int64_t slab = static_cast<int64_t>(p.N) * p.Ho * p.Wo * p.Cout;
  const int iy0 = oy0 * STRIDE - K / 2;
  const int ix0 = ox0 * STRIDE - K / 2;
  // 1 x 1: the input pixel this thread stages (the same every chunk)
  int src_1x1 = -1;
  if (!kRect) {
    const int q = tile * TP + tid % TP;
    if (q < p.Ho * p.Wo) {
      src_1x1 = ((q / p.Wo) * p.stride * p.W + (q % p.Wo) * p.stride) *
                p.Cin;
    }
  }
  for (int t = 0; t < p.T; ++t) {
    const X* __restrict__ xt =
        x + (static_cast<int64_t>(t) * p.N + n) * frame;
    float acc[PXT][4];
#pragma unroll
    for (int j = 0; j < PXT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
    }

    for (int c0 = 0; c0 < p.Cin; c0 += KC) {
      __syncthreads();  // the previous chunk's reads are done
      // input: an item is 8 channels of one pixel; a warp stages 32
      // neighbouring pixels of one channel group
      for (int e = tid; e < G::NPIX * (KC / 8); e += NT) {
        const int pix = e % G::NPIX;
        const int c8 = (e / G::NPIX) * 8;
        int src = -1;
        if (kRect) {
          const int iy = iy0 + pix / WIN;
          const int ix = ix0 + pix % WIN;
          if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
            src = (iy * p.W + ix) * p.Cin;
          }
        } else {
          src = src_1x1;
        }
        float val[8];
        const int nvalid = p.Cin - (c0 + c8);
        if (src >= 0 && nvalid > 0) {
          load8(xt + src + c0 + c8, val, nvalid, p.xvec);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q) val[q] = 0.0f;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) in_s[(c8 + q) * PLANE + pix] = val[q];
      }
      // weights: 4 neighbouring output channels an item
      for (int e = 4 * tid; e < G::W_FLOATS; e += 4 * NT) {
        const int oc = cot * kCo + e % kCo;
        const int ci = c0 + (e / kCo) % KC;
        const int tap = e / (kCo * KC);
        float val[4];
        if (ci < p.Cin) {
          load4(w + (static_cast<int64_t>(tap) * p.Cin + ci) * p.Cout + oc,
                val, min(4, p.Cout - oc), p.vec4);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) val[q] = 0.0f;
        }
        *reinterpret_cast<float4*>(w_s + e) =
            make_float4(val[0], val[1], val[2], val[3]);
      }
      __syncthreads();

      if (kRect) {
        const int r = pg / GPR;
        const int xb = (pg % GPR) * PXT;
#pragma unroll 1
        for (int c = 0; c < KC; ++c) {
#pragma unroll
          for (int dy = 0; dy < K; ++dy) {
            const float* row = in_s + c * PLANE + (r * STRIDE + dy) * WIN +
                               xb * STRIDE;
            float win[WINDOW];
#pragma unroll
            for (int u = 0; u < WINDOW; ++u) win[u] = row[u];
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              const float4 wv = *reinterpret_cast<const float4*>(
                  w_s + ((dy * K + dx) * KC + c) * kCo + cg * 4);
#pragma unroll
              for (int j = 0; j < PXT; ++j) {
                const float in = win[j * STRIDE + dx];
                acc[j][0] = __fmaf_rn(in, wv.x, acc[j][0]);
                acc[j][1] = __fmaf_rn(in, wv.y, acc[j][1]);
                acc[j][2] = __fmaf_rn(in, wv.z, acc[j][2]);
                acc[j][3] = __fmaf_rn(in, wv.w, acc[j][3]);
              }
            }
          }
        }
      } else {
#pragma unroll 8
        for (int c = 0; c < KC; ++c) {
          const float* in_c = in_s + c * PLANE + pg * PXT;
          const float4 wv =
              *reinterpret_cast<const float4*>(w_s + c * kCo + cg * 4);
          float in[PXT];
          if constexpr (PXT == 4) {
            const float4 in4 = *reinterpret_cast<const float4*>(in_c);
            in[0] = in4.x;
            in[1] = in4.y;
            in[2] = in4.z;
            in[3] = in4.w;
          } else {
            const float2 in2 = *reinterpret_cast<const float2*>(in_c);
            in[0] = in2.x;
            in[1] = in2.y;
          }
#pragma unroll
          for (int j = 0; j < PXT; ++j) {
            acc[j][0] = __fmaf_rn(in[j], wv.x, acc[j][0]);
            acc[j][1] = __fmaf_rn(in[j], wv.y, acc[j][1]);
            acc[j][2] = __fmaf_rn(in[j], wv.z, acc[j][2]);
            acc[j][3] = __fmaf_rn(in[j], wv.w, acc[j][3]);
          }
        }
      }
    }

    // epilogue: roundings, affine, cell, z[t]
#pragma unroll
    for (int j = 0; j < PXT; ++j) {
      if (out_off[j] < 0) continue;
      float out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float y = round_to<X>(acc[j][q]);
        y = round_to<X>(__fmaf_rn(y, av[q], bv[q]));
        float vv = v[j][q], ii = i[j][q];
        out[q] = cell_math::cell_step<CELL>(y, vv, ii, p.c_mem, p.c_syn);
        v[j][q] = round_to<S>(vv);
        i[j][q] = round_to<S>(ii);
      }
      store4(z + t * slab + out_off[j], out, nco, p.vec4);
    }
  }

#pragma unroll
  for (int j = 0; j < PXT; ++j) {
    if (out_off[j] < 0) continue;
    store4(static_cast<S*>(p.vT) + out_off[j], v[j], nco, p.vec4);
    store4(static_cast<S*>(p.iT) + out_off[j], i[j], nco, p.vec4);
  }
}

// CTAs of one layer under CTA tile TILE (the plan's grid)
template <int K, int TILE>
int64_t grid_of(const Args& p) {
  constexpr int TH = kTiles[TILE][0], TW = kTiles[TILE][1];
  const int64_t co_tiles = (p.Cout + kCo - 1) / kCo;
  const int64_t tiles =
      K == 3 ? static_cast<int64_t>((p.Ho + TH - 1) / TH) *
                   ((p.Wo + TW - 1) / TW)
             : (static_cast<int64_t>(p.Ho) * p.Wo + TH * TW - 1) / (TH * TW);
  return p.N * tiles * co_tiles;
}

template <int CELL, typename X, typename S, int K, int STRIDE, int TILE>
int launch(const Args& p, int64_t grid, cudaStream_t stream) {
  constexpr int TH = kTiles[TILE][0], TW = kTiles[TILE][1];
  constexpr int PXT = kTiles[TILE][2];
  if (grid != grid_of<K, TILE>(p) || grid > 0x7fffffff) return -1;
  if (grid == 0) return 0;
  constexpr int bytes = Tile<K, STRIDE, TH, TW>::BYTES;
  auto kernel = spiking_conv_kernel<CELL, X, S, K, STRIDE, TH, TW, PXT>;
  if (bytes > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(grid), TH * TW / PXT * kChGroups, bytes,
           stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int CELL, typename X, typename S, int K, int STRIDE>
int launch_tile(int tile, const Args& p, int64_t grid, cudaStream_t s) {
  switch (tile) {
    case 0:
      return launch<CELL, X, S, K, STRIDE, 0>(p, grid, s);
    case 1:
      return launch<CELL, X, S, K, STRIDE, 1>(p, grid, s);
  }
  return -1;
}

template <int CELL, typename X, typename S>
int launch_geometry(int k, int tile, const Args& p, int64_t grid,
                    cudaStream_t s) {
  if (k == 1) return launch_tile<CELL, X, S, 1, 1>(tile, p, grid, s);
  if (k == 3 && p.stride == 1) {
    return launch_tile<CELL, X, S, 3, 1>(tile, p, grid, s);
  }
  if (k == 3 && p.stride == 2) {
    return launch_tile<CELL, X, S, 3, 2>(tile, p, grid, s);
  }
  return -1;
}

template <int CELL, typename X>
int launch_state(int state_dtype, int k, int tile, const Args& p,
                 int64_t grid, cudaStream_t s) {
  switch (state_dtype) {
    case 0:
      return launch_geometry<CELL, X, float>(k, tile, p, grid, s);
    case 1:
      return launch_geometry<CELL, X, __nv_bfloat16>(k, tile, p, grid, s);
    case 2:
      return launch_geometry<CELL, X, E5M2>(k, tile, p, grid, s);
  }
  return -1;
}

template <int CELL>
int launch_x(int x_dtype, int state_dtype, int k, int tile, const Args& p,
             int64_t grid, cudaStream_t s) {
  switch (x_dtype) {
    case 0:
      return launch_state<CELL, float>(state_dtype, k, tile, p, grid, s);
    case 1:
      return launch_state<CELL, __nv_bfloat16>(state_dtype, k, tile, p, grid,
                                               s);
  }
  return -1;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

Args make_args(const void* x, const void* w, const float* a, const float* b,
               const void* v0, const void* i0, void* z, void* vT, void* iT,
               int T, int N, int H, int W, int Cin, int Ho, int Wo, int Cout,
               int stride, float c_mem, float c_syn) {
  Args p{x, w, a, b, v0, i0, z, vT, iT, T, N, H, W, Cin, Ho, Wo, Cout,
         stride, c_mem, c_syn, false, false};
  p.vec4 = Cout % 4 == 0 && aligned16(w) && aligned16(v0) &&
           aligned16(i0) && aligned16(z) && aligned16(vT) && aligned16(iT);
  p.xvec = Cin % 8 == 0 && aligned16(x);
  return p;
}

bool fits_int(long long v) { return v >= 0 && v <= 0x7fffffff; }

}  // namespace

// C entry points (loaded with ctypes). Type codes: 0 fp32, 1 bf16,
// 2 fp8 e5m2 (state only); cell 0 = LIF, 1 = LI; tile indexes kTiles
// and grid is the plan's CTA count. Each returns 0 on success, -1 for
// an unsupported argument or a grid that is not the tile's, else the
// cudaError_t of the launch. Shapes are checked by the Python wrappers.
extern "C" int spiking_conv_seq_launch(
    const void* x, const void* w, const float* a, const float* b,
    const void* v0, const void* i0, void* z, void* vT, void* iT, int T,
    int N, int H, int W, int Cin, int Ho, int Wo, int Cout, int k,
    int stride, int tile, long long grid, int cell, int x_dtype,
    int state_dtype, float c_mem, float c_syn, void* stream) {
  if (T < 0 || N < 0 || Cin <= 0 || Cout <= 0 || (stride != 1 && stride != 2)
      || !fits_int(static_cast<long long>(H) * W * Cin)) {
    return -1;
  }
  const Args p = make_args(x, w, a, b, v0, i0, z, vT, iT, T, N, H, W, Cin,
                           Ho, Wo, Cout, stride, c_mem, c_syn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cell == cell_math::kLIF) {
    return launch_x<cell_math::kLIF>(x_dtype, state_dtype, k, tile, p, grid,
                                     s);
  }
  if (cell == cell_math::kLI) {
    return launch_x<cell_math::kLI>(x_dtype, state_dtype, k, tile, p, grid,
                                    s);
  }
  return -1;
}
