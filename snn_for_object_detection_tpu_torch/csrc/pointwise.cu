// Fused 1 x 1 conv (a channel matmul) + eval BatchNorm + one LIF step,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_pointwise_conv_bn_lif`
// (`_fused_kernel` under its pallas_call) of
// snn_for_object_detection_tpu/ops/pallas_kernels.py:
//   in:  x[N, Cin] and w[Cin, Cout] (fp32 or bf16), a, b[Cout] fp32,
//        v, i[N, Cout] (fp32, bf16, fp8 e5m2 or e4m3)
//   out: z[N, Cout] in x's type, v', i' in the state type
//   y = x @ w summed in fp32; y = fma(y, a, b), not rounded to x's type;
//   v_dec = fma(i - v, c_mem, v), i_dec = fma(i, -c_syn, i);
//   z = v_dec > 1; v' = (1 - z) * v_dec; i' = i_dec + y.
// z and v' do not depend on the product; only i' does.
//
// What bounds it: bytes. A row moves Cin values of x in and Cout values
// of z, v, i, v', i' through HBM against 2 * Cin * Cout flops, far below
// the card's flops per byte (fp32 FFMA at Cin = Cout = 256 is the one
// case near its operations bound). So the design streams the bytes and
// keeps the math off the critical path:
//   - weights resident: a CTA loads its [Cin, Cout_tile] slab of w, and
//     a, b, into shared memory once, then loops over row tiles
//     (persistent: grid = SMs x CTAs an SM, row tiles in a strided
//     loop). Cout_tile = Cout wherever the slab fits, so x is read once;
//     where it does not (fp32 256 -> 256) Cout is split and the CTAs of
//     one row tile's splits run side by side, so all but the first read
//     x from L2;
//   - a ring of 2 stages in shared memory: each stage holds one row
//     tile's x, v and i, copied with 16-byte cp.async while the tile
//     before it is computed (deeper rings changed no case by more than
//     a few percent and cost rows a tile: PERF.md). The copies land in rows padded by 16 bytes,
//     which makes every ldmatrix of x and w conflict-free (a 64-channel
//     bf16 row is 128 bytes: unpadded, the 8 rows of an 8 x 8 matrix
//     share one bank group) and keeps the epilogue's accesses spread;
//     the same copy takes a split Cout's column slice and a tail tile. A
//     whole-tile 1-D bulk copy cannot pad rows, and a trial build with a
//     bulk copy (TMA) a row was slower than cp.async (PERF.md). A
//     stream whose base or row length is not a multiple of 16 bytes (Cin
//     = 40 in e5m2, x[1:] of an odd-width x) is staged value by value,
//     in the same kernel;
//   - math: fp32 runs on FFMA in CTAs of 128 threads, a thread RM rows
//     (1, 2 or 4, a template parameter) x 8 channels (TF32 would change
//     JAX's fp32 results past i''s tolerance); bf16 runs on the tensor
//     cores (mma.sync m16n8k16, fp32 sums; x with ldmatrix, w with
//     ldmatrix.trans) in CTAs of 256 threads, each warp 16 rows x up to
//     64 channels;
//   - epilogue, per tile: each thread turns its own accumulators into
//     the cell's outputs, two neighbouring channels at a time: v and i
//     from the stage, y = fma(acc, a, b), then z over x's slot (the
//     product is done with it), v' over v and i' over i; a last pass
//     stores z, v' and i' with 16-byte stores (e5m2: 16 values a store).
// The cell is cell_math::cell_step<kLIF, true>, shared with the other
// kernels, so z and v' are bit-equal to the plain version; the sources
// build with --fmad=false. Each output sums its products in the same
// order under every plan (k ascending on FFMA, the mma's own order on
// the tensor cores), so the plans give the same bits.
//
// The launch plan (rows a tile, Cout_tile, grid) is chosen by
// ops/cuda_kernels.py::pointwise_plan; the entry point recomputes the
// shared memory the plan implies and refuses a plan that does not match.

#include "cell_math.cuh"

namespace {

using cell_math::E4M3;
using cell_math::E5M2;
using cell_math::from_f32;
using cell_math::to_f32;

constexpr int kThreads = 256;  // a CTA in the mma branch; FFMA: 128
constexpr int kMaxSmem = 232448;  // 227 KB: a CTA's most on sm_90
constexpr int kStages = 2;  // the ring

struct Args {
  const void* x;
  const void* w;
  const float* a;
  const float* b;
  const void* v;
  const void* i;
  void* z;
  void* v_out;
  void* i_out;
  long long n;
  int cin, cout;
  int rows;       // rows a tile
  int cout_tile;  // output channels a CTA
  int splits;     // Cout tiles
  int threads;    // a CTA: 256 (mma) or 128 (FFMA)
  float c_mem, c_syn;
  bool xvec;  // x staged in 16-byte copies
  bool wvec;  // w staged in 16-byte copies
  bool svec;  // v, i staged in 16-byte copies
  bool ovec;  // z, v', i' stored in 16-byte (or CH-value) vectors
};

// Shared-memory geometry of one launch, in elements and bytes; rows are
// padded by 16 bytes (see the header). Mirrored by
// ops/cuda_kernels.py::pointwise_plan.
struct Geometry {
  int kpad;   // Cin padded to the math's k step (16 for mma, 4 for FFMA)
  int xs;     // x row stride (elements)
  int wc;     // weight columns (Cout_tile padded to 8 or 4)
  int ws;     // w row stride (elements)
  int vc;     // state columns (Cout_tile padded to CH)
  int vs;     // v, i row stride (elements)
  int zs;     // z row stride (elements; z takes x's slot after the product)
  int w_bytes, ab_bytes, x_bytes, s_bytes, stage_bytes, smem;
};

__host__ __device__ inline Geometry geometry(int cin, int cout_tile,
                                             int rows, int sx, int ss) {
  const bool mma = sx == 2;
  const int ch = 16 / ss;
  Geometry g;
  g.kpad = (cin + (mma ? 15 : 3)) / (mma ? 16 : 4) * (mma ? 16 : 4);
  g.xs = g.kpad + 16 / sx;
  g.wc = (cout_tile + (mma ? 7 : 3)) / (mma ? 8 : 4) * (mma ? 8 : 4);
  g.ws = g.wc + 16 / sx;
  g.vc = (cout_tile + ch - 1) / ch * ch;
  g.vs = g.vc + ch;
  g.zs = (g.vc + 16 / sx - 1) / (16 / sx) * (16 / sx) + 16 / sx;
  g.w_bytes = g.kpad * g.ws * sx;
  g.ab_bytes = (2 * g.wc * 4 + 15) / 16 * 16;
  g.x_bytes = rows * (g.xs > g.zs ? g.xs : g.zs) * sx;
  g.s_bytes = rows * g.vs * ss;
  g.stage_bytes = g.x_bytes + 2 * g.s_bytes;
  g.smem = g.w_bytes + g.ab_bytes + kStages * g.stage_bytes;
  return g;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// rows x cols values of type T from global src (row r at src + r * sstride)
// to shared dst (row r at dst + r * dstride): 16-byte cp.async where
// `vec` (each row's start and byte count multiples of 16), else value by
// value
template <int NT, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dstride,
                                           const T* src, long long sstride,
                                           int rows, int cols, bool vec,
                                           int tid) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int chunks = cols / kPer;
    for (int e = tid; e < rows * chunks; e += NT) {
      const int r = e / chunks, c = (e - r * chunks) * kPer;
      cp_async16(dst + r * dstride + c, src + r * sstride + c);
    }
  } else {
    for (int e = tid; e < rows * cols; e += NT) {
      const int r = e / cols, c = e - r * cols;
      dst[r * dstride + c] = src[r * sstride + c];
    }
  }
}

// CH values of type T to global memory: vector stores of CH * sizeof(T)
// bytes (16-byte pieces where larger) where `vec`, else the first
// `nvalid` one by one
template <typename T, int CH>
__device__ __forceinline__ void store_ch(T* dst, const T (&val)[CH],
                                         int nvalid, bool vec) {
  constexpr int kBytes = CH * sizeof(T);
  if (vec && nvalid == CH) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int q = 0; q < kBytes / 16; ++q) {
        reinterpret_cast<uint4*>(dst)[q] =
            reinterpret_cast<const uint4*>(val)[q];
      }
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(val);
    } else {
      *reinterpret_cast<unsigned*>(dst) =
          *reinterpret_cast<const unsigned*>(val);
    }
  } else {
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      if (q < nvalid) dst[q] = val[q];
    }
  }
}

// CH values of type T from shared memory, in the widest moves their
// alignment allows (the z, v and i rows and items are 8- or 16-byte
// aligned)
template <typename T, int CH>
__device__ __forceinline__ void load_ch(T (&dst)[CH], const T* src) {
  constexpr int kBytes = CH * sizeof(T);
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q) {
      reinterpret_cast<uint4*>(dst)[q] =
          reinterpret_cast<const uint4*>(src)[q];
    }
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else {
    *reinterpret_cast<unsigned*>(dst) =
        *reinterpret_cast<const unsigned*>(src);
  }
}

// two neighbouring values in shared memory, widened to fp32 or rounded
// from it (the same conversions as cell_math's, two at a time)
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  a = t.x;
  b = t.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const float2 t =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = t.x;
  b = t.y;
}
__device__ __forceinline__ void load2(const E5M2* p, float& a, float& b) {
  a = to_f32(p[0]);
  b = to_f32(p[1]);
}
__device__ __forceinline__ void load2(const E4M3* p, float& a, float& b) {
  a = to_f32(p[0]);
  b = to_f32(p[1]);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(E5M2* p, float a, float b) {
  const unsigned lo = from_f32<E5M2>(a).bits, hi = from_f32<E5M2>(b).bits;
  *reinterpret_cast<unsigned short*>(p) =
      static_cast<unsigned short>(lo | (hi << 8));
}
__device__ __forceinline__ void store2(E4M3* p, float a, float b) {
  const unsigned lo = from_f32<E4M3>(a).bits, hi = from_f32<E4M3>(b).bits;
  *reinterpret_cast<unsigned short*>(p) =
      static_cast<unsigned short>(lo | (hi << 8));
}

// MMA: shape of a warp's block. BM / 16 warps along rows (each 16 rows),
// the rest along channels, each warp ceil(wc / 8 / WN) n8 tiles (at most
// 8, checked by the entry point).
struct WarpTile {
  int wm, wn, npw;
};
__host__ __device__ inline WarpTile warp_tile(int rows, int wc) {
  WarpTile t;
  t.wm = rows / 16;
  t.wn = (kThreads / 32) / t.wm;
  t.npw = (wc / 8 + t.wn - 1) / t.wn;
  return t;
}

// FFMA: a thread owns rm consecutive rows (1, 2 or 4) x 8 channels, two
// quads cgp * 4 apart (cg * 4 and cgp * 4 + cg * 4), so that the w reads
// of neighbouring threads are neighbouring 16-byte words; cgp channel
// groups (a power of two, 1 to 16) x threads / cgp row groups
struct ThreadTile {
  int cgp, rg, rm;
};
__host__ __device__ inline ThreadTile thread_tile(int rows, int wc,
                                                  int threads) {
  ThreadTile t;
  t.cgp = 1;
  while (t.cgp * 8 < wc) t.cgp *= 2;
  t.rg = threads / t.cgp;
  t.rm = t.rg > 0 ? rows / t.rg : 0;
  return t;
}

// RM: rows a thread in the FFMA branch (1, 2 or 4; 1 for mma); NT:
// threads a CTA, 256 for mma and 128 for FFMA: the FFMA product is
// bound by its shared-memory load instructions, so a tile is better
// spread over fewer threads with more outputs each, and more CTAs an SM
// (PERF.md, Findings)
template <typename X, typename S, int RM, int NT>
__global__ void __launch_bounds__(NT, 2) pointwise_kernel(const Args p) {
  constexpr bool kMma = sizeof(X) == 2;
  constexpr int CH = 16 / sizeof(S);  // state values in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry g =
      geometry(p.cin, p.cout_tile, p.rows, sizeof(X), sizeof(S));
  X* w_s = reinterpret_cast<X*>(smem);
  float* a_s = reinterpret_cast<float*>(smem + g.w_bytes);
  float* b_s = a_s + g.wc;
  unsigned char* ring = smem + g.w_bytes + g.ab_bytes;

  const int tid = threadIdx.x;
  const int split = blockIdx.x % p.splits;
  const int co0 = split * p.cout_tile;
  const int cvalid = min(p.cout_tile, p.cout - co0);
  const X* __restrict__ x = static_cast<const X*>(p.x);
  const S* __restrict__ v = static_cast<const S*>(p.v);
  const S* __restrict__ iin = static_cast<const S*>(p.i);
  X* __restrict__ z = static_cast<X*>(p.z);
  S* __restrict__ v_out = static_cast<S*>(p.v_out);
  S* __restrict__ i_out = static_cast<S*>(p.i_out);

  // this CTA's row tiles: blockIdx / splits, then every grid / splits
  const long long row_tiles = (p.n + p.rows - 1) / p.rows;
  const long long first = blockIdx.x / p.splits;
  const long long step = gridDim.x / p.splits;
  const int count =
      first < row_tiles ? static_cast<int>((row_tiles - 1 - first) / step) + 1
                        : 0;

  auto x_of = [&](int s) {
    return reinterpret_cast<X*>(ring + s * g.stage_bytes);
  };
  auto v_of = [&](int s) {
    return reinterpret_cast<S*>(ring + s * g.stage_bytes + g.x_bytes);
  };
  auto i_of = [&](int s) {
    return reinterpret_cast<S*>(ring + s * g.stage_bytes + g.x_bytes +
                                g.s_bytes);
  };
  // stage row tile k of this CTA into ring slot s (16-byte cp.async, or
  // value by value)
  auto issue = [&](int k, int s) {
    const long long row0 = (first + k * step) * p.rows;
    const int nrows =
        static_cast<int>(p.n - row0 < p.rows ? p.n - row0 : p.rows);
    stage_rows<NT>(x_of(s), g.xs, x + row0 * p.cin, p.cin, nrows, p.cin, p.xvec,
               tid);
    // zeros in x's columns [Cin, kpad): z of an earlier tile was there
    const int xpad = g.kpad - p.cin;
    for (int e = tid; e < nrows * xpad; e += NT) {
      const int r = e / xpad;
      x_of(s)[r * g.xs + p.cin + e - r * xpad] = from_f32<X>(0.0f);
    }
    const long long so = row0 * p.cout + co0;
    stage_rows<NT>(v_of(s), g.vs, v + so, p.cout, nrows, cvalid, p.svec, tid);
    stage_rows<NT>(i_of(s), g.vs, iin + so, p.cout, nrows, cvalid, p.svec, tid);
  };

  // once a CTA: the weight slab with zero rows past Cin (they meet x's
  // zero columns), a and b. Columns past cvalid are left as they are:
  // they only feed outputs that are never stored
  stage_rows<NT>(w_s, g.ws, static_cast<const X*>(p.w) + co0, p.cout, p.cin,
             cvalid, p.wvec, tid);
  for (int e = p.cin * g.ws + tid; e < g.kpad * g.ws; e += NT) {
    w_s[e] = from_f32<X>(0.0f);
  }
  for (int c = tid; c < cvalid; c += NT) {
    a_s[c] = p.a[co0 + c];
    b_s[c] = p.b[co0 + c];
  }

  // tile 0 in flight; the weight slab's copies join its group
  if (count > 0) issue(0, 0);
  cp_async_commit();

  // this thread's item of the store pass: row r_item of every rstep,
  // channels [c_item, c_item + CH)
  const int nch = g.vc / CH;  // CH-value items of a state row
  const int rstep = NT / nch;
  const int r_item = tid < rstep * nch ? tid / nch : p.rows;
  const int c_item = (tid % nch) * CH;
  for (int k = 0; k < count; ++k) {
    __syncthreads();  // slot (k + 1) % 2, tile k - 1's, is consumed
    if (k + 1 < count) issue(k + 1, (k + 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile k's copies (this thread's) landed
    __syncthreads();               // everyone's have

    const int s = k % kStages;
    X* xs = x_of(s);  // x, and z once the product is done
    S* vs = v_of(s);
    S* is = i_of(s);
    const long long row0 = (first + k * step) * p.rows;
    const int nrows =
        static_cast<int>(p.n - row0 < p.rows ? p.n - row0 : p.rows);

    // the cell on two neighbouring outputs (r, c), (r, c + 1) from their
    // fp32 sums: z over x's slot, v' and i' over v and i in the stage
    auto cell2 = [&](float y0, float y1, int r, int c) {
      float v0, v1, i0, i1;
      load2(vs + r * g.vs + c, v0, v1);
      load2(is + r * g.vs + c, i0, i1);
      const float z0 = cell_math::cell_step<cell_math::kLIF, true>(
          __fmaf_rn(y0, a_s[c], b_s[c]), v0, i0, p.c_mem, p.c_syn);
      const float z1 = cell_math::cell_step<cell_math::kLIF, true>(
          __fmaf_rn(y1, a_s[c + 1], b_s[c + 1]), v1, i1, p.c_mem, p.c_syn);
      store2(xs + r * g.zs + c, z0, z1);
      store2(vs + r * g.vs + c, v0, v1);
      store2(is + r * g.vs + c, i0, i1);
    };

    if constexpr (kMma) {
      const WarpTile t = warp_tile(p.rows, g.wc);
      const int warp = tid / 32, lane = tid % 32;
      const int wm = warp % t.wm, wn = warp / t.wm;
      const int n0 = wn * t.npw * 8;
      const int npw = max(0, min(t.npw, g.wc / 8 - wn * t.npw));
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
      }
      for (int k0 = 0; k0 < g.kpad; k0 += 16) {
        unsigned af[4];
        ldmatrix_x4<false>(af, xs + (wm * 16 + lane % 16) * g.xs + k0 +
                                   lane / 16 * 8);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          if (j < npw) {
            unsigned bf[4];
            ldmatrix_x4<true>(bf, w_s + (k0 + lane % 16) * g.ws + n0 +
                                      j * 8 + lane / 16 * 8);
            mma_bf16(acc[j], af, bf[0], bf[1]);
            if (j + 1 < npw) mma_bf16(acc[j + 1], af, bf[2], bf[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with x: its slot takes z
      // acc[j] holds rows r0, r0 + 8 x channels c, c + 1. Rows past the
      // tail and channels past cvalid (up to wc, inside every stage row)
      // are computed too and never stored
      const int r0 = wm * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= npw) break;
        const int c = n0 + j * 8 + (lane % 4) * 2;
        cell2(acc[j][0], acc[j][1], r0, c);
        cell2(acc[j][2], acc[j][3], r0 + 8, c);
      }
    } else {
      const ThreadTile t = thread_tile(p.rows, g.wc, NT);
      const int cg = tid % t.cgp, rb = (tid / t.cgp) * RM;
      const int c0 = cg * 4, c1 = t.cgp * 4 + cg * 4;  // the two quads
      const bool q0 = c0 < g.wc, q1 = c1 < g.wc;
      const float* xr = reinterpret_cast<const float*>(xs) + rb * g.xs;
      const float* wr = reinterpret_cast<const float*>(w_s);
      float acc[RM][8];
#pragma unroll
      for (int j = 0; j < RM; ++j) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[j][q] = 0.0f;
      }
      for (int k0 = 0; k0 < g.kpad; k0 += 4) {
        float4 xv[RM], w0[4], w1[4];
#pragma unroll
        for (int j = 0; j < RM; ++j) {
          xv[j] = *reinterpret_cast<const float4*>(xr + j * g.xs + k0);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* row = wr + (k0 + kk) * g.ws;
          w0[kk] = q0 ? *reinterpret_cast<const float4*>(row + c0)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          w1[kk] = q1 ? *reinterpret_cast<const float4*>(row + c1)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // k ascending for every output
#pragma unroll
          for (int j = 0; j < RM; ++j) {
            const float xk = kk == 0   ? xv[j].x
                             : kk == 1 ? xv[j].y
                             : kk == 2 ? xv[j].z
                                       : xv[j].w;
            float* a0 = acc[j];
            a0[0] = __fmaf_rn(xk, w0[kk].x, a0[0]);
            a0[1] = __fmaf_rn(xk, w0[kk].y, a0[1]);
            a0[2] = __fmaf_rn(xk, w0[kk].z, a0[2]);
            a0[3] = __fmaf_rn(xk, w0[kk].w, a0[3]);
            a0[4] = __fmaf_rn(xk, w1[kk].x, a0[4]);
            a0[5] = __fmaf_rn(xk, w1[kk].y, a0[5]);
            a0[6] = __fmaf_rn(xk, w1[kk].z, a0[6]);
            a0[7] = __fmaf_rn(xk, w1[kk].w, a0[7]);
          }
        }
      }
      __syncthreads();  // every thread is done with x: its slot takes z
      // as in the mma branch, rows past the tail and channels past cvalid
      // are computed and never stored
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        if (q0) {
          cell2(acc[j][0], acc[j][1], rb + j, c0);
          cell2(acc[j][2], acc[j][3], rb + j, c0 + 2);
        }
        if (q1) {
          cell2(acc[j][4], acc[j][5], rb + j, c1);
          cell2(acc[j][6], acc[j][7], rb + j, c1 + 2);
        }
      }
    }
    __syncthreads();  // z, v', i' are in the stage

    // z, v', i' to device memory, CH values (16 bytes of state) an item;
    // a pass covers rstep rows
    for (int r = r_item; r < nrows; r += rstep) {
      const long long o = (row0 + r) * p.cout + co0 + c_item;
      const int nv = min(CH, cvalid - c_item);
      alignas(16) X zo[CH];
      alignas(16) S so[CH];
      load_ch(zo, xs + r * g.zs + c_item);
      store_ch<X, CH>(z + o, zo, nv, p.ovec);
      load_ch(so, vs + r * g.vs + c_item);
      store_ch<S, CH>(v_out + o, so, nv, p.ovec);
      load_ch(so, is + r * g.vs + c_item);
      store_ch<S, CH>(i_out + o, so, nv, p.ovec);
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (empty groups only)
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

// the kernel instance of a launch (nullptr if there is none): mma with
// 256 threads, or FFMA with 128 threads and 1, 2 or 4 rows a thread
template <typename X, typename S>
auto kernel_of(int rows, int wc, int threads)
    -> decltype(&pointwise_kernel<X, S, 1, kThreads>) {
  if constexpr (sizeof(X) == 2) {
    return threads == kThreads ? pointwise_kernel<X, S, 1, kThreads>
                               : nullptr;
  } else {
    if (threads != kThreads / 2) return nullptr;
    switch (thread_tile(rows, wc, threads).rm) {
      case 1:
        return pointwise_kernel<X, S, 1, kThreads / 2>;
      case 2:
        return pointwise_kernel<X, S, 2, kThreads / 2>;
      case 4:
        return pointwise_kernel<X, S, 4, kThreads / 2>;
    }
    return nullptr;
  }
}

template <typename X, typename S>
int occupancy(const Args& p, int smem, int* blocks) {
  const Geometry g =
      geometry(p.cin, p.cout_tile, p.rows, sizeof(X), sizeof(S));
  auto kernel = kernel_of<X, S>(p.rows, g.wc, p.threads);
  if (kernel == nullptr) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      p.threads, smem);
  return static_cast<int>(err);
}

template <typename X, typename S>
int launch(Args p, long long grid, int smem, cudaStream_t stream) {
  constexpr int sx = sizeof(X), ss = sizeof(S), ch = 16 / ss;
  const Geometry g = geometry(p.cin, p.cout_tile, p.rows, sx, ss);
  if (g.smem != smem || smem > kMaxSmem || g.vc / ch > p.threads) {
    return -1;
  }
  if (sx == 2) {  // mma: 16-row warps, at most 8 n8 tiles a warp
    if (p.rows != 16 && p.rows != 32 && p.rows != 64 && p.rows != 128) {
      return -1;
    }
    if (warp_tile(p.rows, g.wc).npw > 8) return -1;
  } else {  // FFMA: up to 16 channel groups, 1, 2 or 4 rows a thread
    const ThreadTile t = thread_tile(p.rows, g.wc, p.threads);
    if (t.cgp > 16 || t.rg < 1 || t.rm * t.rg != p.rows) return -1;
  }
  auto kernel = kernel_of<X, S>(p.rows, g.wc, p.threads);
  if (kernel == nullptr) return -1;
  p.xvec = aligned16(p.x) && p.cin % (16 / sx) == 0;
  p.wvec = aligned16(p.w) && p.cout % (16 / sx) == 0 &&
           p.cout_tile % (16 / sx) == 0;
  p.svec = aligned16(p.v) && aligned16(p.i) && p.cout % ch == 0 &&
           p.cout_tile % ch == 0;
  p.ovec = aligned16(p.z) && aligned16(p.v_out) && aligned16(p.i_out) &&
           p.cout % ch == 0 && p.cout_tile % ch == 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), p.threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename X>
int by_state(int state_dtype, const Args& p, long long grid, int smem,
             cudaStream_t s, int* blocks) {
  switch (state_dtype) {
    case 0:
      return blocks ? occupancy<X, float>(p, smem, blocks)
                    : launch<X, float>(p, grid, smem, s);
    case 1:
      return blocks ? occupancy<X, __nv_bfloat16>(p, smem, blocks)
                    : launch<X, __nv_bfloat16>(p, grid, smem, s);
    case 2:
      return blocks ? occupancy<X, E5M2>(p, smem, blocks)
                    : launch<X, E5M2>(p, grid, smem, s);
    case 3:
      return blocks ? occupancy<X, E4M3>(p, smem, blocks)
                    : launch<X, E4M3>(p, grid, smem, s);
  }
  return -1;
}

int by_x(int x_dtype, int state_dtype, const Args& p, long long grid,
         int smem, cudaStream_t s, int* blocks) {
  switch (x_dtype) {
    case 0:
      return by_state<float>(state_dtype, p, grid, smem, s, blocks);
    case 1:
      return by_state<__nv_bfloat16>(state_dtype, p, grid, smem, s, blocks);
  }
  return -1;
}

}  // namespace

// C entry points (loaded with ctypes). Type codes: 0 fp32, 1 bf16,
// 2 fp8 e5m2, 3 fp8 e4m3 (state only). Each returns 0 on success, -1 for an
// unsupported argument or a plan that is not consistent, else the
// cudaError_t of the call. Shapes are checked by the Python wrapper.

// CTAs of the instance a plan of `rows` rows x `cout_tile` channels and
// `threads` threads launches that fit an SM at `smem` bytes of shared
// memory
extern "C" int pointwise_occupancy(int x_dtype, int state_dtype, int cin,
                                   int rows, int cout_tile, int threads,
                                   int smem, int* blocks) {
  *blocks = 0;
  if (cin <= 0 || rows <= 0 || cout_tile <= 0) return -1;
  Args p{};
  p.cin = cin;
  p.rows = rows;
  p.cout_tile = cout_tile;
  p.threads = threads;
  return by_x(x_dtype, state_dtype, p, 0, smem, nullptr, blocks);
}

// z, v', i' = one LIF step of (v, i) with input x[n, Cin] @ w[Cin, Cout]
// * a + b, under the plan (rows a tile, Cout_tile, threads a CTA, smem,
// grid)
extern "C" int fused_pointwise_launch(
    const void* x, const void* w, const float* a, const float* b,
    const void* v, const void* i, void* z, void* v_out, void* i_out,
    long long n, int cin, int cout, int rows, int cout_tile, int threads,
    int smem, long long grid, int x_dtype, int state_dtype, float c_mem,
    float c_syn, void* stream) {
  if (n < 0 || cin <= 0 || cout <= 0 || rows <= 0 || cout_tile <= 0 ||
      cout_tile > cout) {
    return -1;
  }
  const int splits = (cout + cout_tile - 1) / cout_tile;
  const long long items = (n + rows - 1) / rows * splits;
  if (grid < 0 || grid > 0x7fffffff || grid % splits != 0 ||
      grid > items || (items > 0 && grid == 0)) {
    return -1;
  }
  if (grid == 0) return 0;
  Args p{x,      w,       a,     b,     v,     i,     z,    v_out,
         i_out,  n,       cin,   cout,  rows,  cout_tile, splits,
         threads, c_mem,  c_syn, false, false, false, false};
  return by_x(x_dtype, state_dtype, p, grid, smem,
              static_cast<cudaStream_t>(stream), nullptr);
}
