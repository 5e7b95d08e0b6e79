// The cell kernels' device code and launch templates: LIF and LI over
// T steps and their backward (temporal_cell.cu's entry points), and
// PLIF, LIF with per-channel Euler factors (plif_cell.cu's). The two
// sources include this header and instantiate only their own cells, so
// that nvcc builds them at once, in two processes. The design of the
// kernels is described in temporal_cell.cu and plif_cell.cu.

#pragma once

#include "cell_math.cuh"

namespace {

using cell_math::E4M3;
using cell_math::E5M2;
using cell_math::from_f32;
using cell_math::kLI;
using cell_math::kLIF;
using cell_math::kPLIF;
using cell_math::to_f32;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T a[N];
};

// The Euler factors of a launch: LIF's or LI's two constants, or PLIF's
// per-channel vectors cm[C], cs[C].
struct Factors {
  const float* cm;
  const float* cs;
  int C;
  float c_mem, c_syn;
};

// The factors of a thread's V elements from base on.
template <int CELL, int V>
__device__ __forceinline__ void load_factors(const Factors& f, int64_t base,
                                             float (&fm)[V], float (&fs)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (CELL == kPLIF) {
      const int c = static_cast<int>((base + k) % f.C);
      fm[k] = f.cm[c];
      fs[k] = f.cs[c];
    } else {
      fm[k] = f.c_mem;
      fs[k] = f.c_syn;
    }
  }
}

template <int CELL, typename X, typename S, int V>
__global__ void __launch_bounds__(256) temporal_cell_kernel(
    const X* __restrict__ x, const S* __restrict__ v0,
    const S* __restrict__ i0, X* __restrict__ z, S* __restrict__ vT,
    S* __restrict__ iT, int T, int64_t M, int start, Factors f) {
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (base >= M) return;

  float fm[V], fs[V];
  load_factors<CELL, V>(f, base, fm, fs);
  float v[V], i[V];
  {
    const Vec<S, V> vs = *reinterpret_cast<const Vec<S, V>*>(v0 + base);
    const Vec<S, V> is = *reinterpret_cast<const Vec<S, V>*>(i0 + base);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = to_f32(vs.a[k]);
      i[k] = to_f32(is.a[k]);
    }
  }

  Vec<X, V> xn;
  if (T > 0) xn = *reinterpret_cast<const Vec<X, V>*>(x + base);
  for (int t = 0; t < T; ++t) {
    const Vec<X, V> xc = xn;
    if (t + 1 < T) {
      xn = *reinterpret_cast<const Vec<X, V>*>(x + (t + 1) * M + base);
    }
    const bool active = t >= start;
    Vec<X, V> zo;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v_new = v[k], i_new = i[k];
      const float out = cell_math::cell_step<CELL>(to_f32(xc.a[k]), v_new,
                                                   i_new, fm[k], fs[k]);
      zo.a[k] = from_f32<X>(out);
      if (active) {
        v[k] = to_f32(from_f32<S>(v_new));
        i[k] = to_f32(from_f32<S>(i_new));
      }
    }
    *reinterpret_cast<Vec<X, V>*>(z + t * M + base) = zo;
  }

  Vec<S, V> vs, is;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    vs.a[k] = from_f32<S>(v[k]);
    is.a[k] = from_f32<S>(i[k]);
  }
  *reinterpret_cast<Vec<S, V>*>(vT + base) = vs;
  *reinterpret_cast<Vec<S, V>*>(iT + base) = is;
}

// s = v_dec - v_th of the LIF step that starts from (v, i): the one value
// of the state that the step's VJP reads (the ops of cell_step's spike
// test, so the same bits).
__device__ __forceinline__ float lif_s(float v, float i, float c_mem) {
  const float d = __fadd_rn(__fsub_rn(0.0f, v), i);
  return __fsub_rn(__fmaf_rn(d, c_mem, v), 1.0f);
}

// One step's VJP for one element. s: lif_s of the state entering the
// step (LIF only); g: the output's cotangent; (gvn, gin): the new state's.
// Returns the cotangents of the step's input state in (gv, gi) and of x,
// and in g_vdec the cotangent of the decayed membrane.
template <int CELL>
__device__ __forceinline__ float cell_step_vjp(float s, float g, float gvn,
                                               float gin, float c_mem,
                                               float c_syn, float alpha,
                                               float& gv, float& gi,
                                               float& g_vdec) {
  if (CELL == kLIF) {
    const float q = __fadd_rn(__fmul_rn(alpha, fabsf(s)), 1.0f);
    const float sg = __fdiv_rn(g, __fmul_rn(q, q));
    // (1 - z) * gvn, as JAX differentiates the reset: NaN where a
    // spiking element's carried cotangent is NaN or inf
    g_vdec = __fadd_rn(__fmul_rn(s > 0.0f ? 0.0f : 1.0f, gvn), sg);
  } else {
    g_vdec = __fadd_rn(gvn, g);  // LI: the output is the new v
  }
  const float g_d = __fmul_rn(g_vdec, c_mem);
  gv = __fadd_rn(g_vdec, -g_d);
  // the current's three uses, summed as autograd sums them: the decay's
  // product and its addend first, then the membrane update's
  gi = __fadd_rn(__fadd_rn(__fmul_rn(gin, -c_syn), gin), g_d);
  return CELL == kLIF ? gin : gi;  // LI: x enters through the jump
}

// Step t of the reverse walk for a thread's V elements: the VJP from the
// carried cotangents (Gv, Gi), rounded to the state type as they are
// stored between steps, and the truncation gate: a frozen step holds
// the carried state, so its cotangent passes on, plus the one from the
// step's output. Returns gx[t].
template <int CELL, typename X, typename S, int V>
__device__ __forceinline__ Vec<X, V> bwd_step(const float (&s)[V],
                                              const Vec<X, V>& g,
                                              bool active, float (&Gv)[V],
                                              float (&Gi)[V],
                                              const float (&fm)[V],
                                              const float (&fs)[V],
                                              float alpha) {
  Vec<X, V> gxo;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float gvr = cell_math::round_to<S>(Gv[k]);
    const float gir = cell_math::round_to<S>(Gi[k]);
    float gv, gi, g_vdec;
    const float gxv = cell_step_vjp<CELL>(
        s[k], to_f32(g.a[k]), active ? gvr : 0.0f, active ? gir : 0.0f,
        fm[k], fs[k], alpha, gv, gi, g_vdec);
    gxo.a[k] = from_f32<X>(gxv);
    gv = cell_math::round_to<S>(gv);
    gi = cell_math::round_to<S>(gi);
    Gv[k] = active ? gv : __fadd_rn(gv, gvr);
    Gi[k] = active ? gi : __fadd_rn(gi, gir);
  }
  return gxo;
}

// PLIF's step t of the reverse walk: bwd_step's LIF VJP from the state
// (v, i) entering the step, which gives s and d = (v_leak - v) + i, and
// the step's cotangents of the factors added to each element's sums:
// g_vdec * d to Gm (c_mem multiplies d), gin * i to Gs (-c_syn
// multiplies i; the wrapper negates the sum). The products are the ones
// autograd forms through ops/neurons.py's plif_step_factors.
template <typename X, typename S, int V>
__device__ __forceinline__ Vec<X, V> plif_bwd_step(
    const float (&v)[V], const float (&i)[V], const Vec<X, V>& g,
    bool active, float (&Gv)[V], float (&Gi)[V], const float (&fm)[V],
    const float (&fs)[V], float alpha, float (&Gm)[V], float (&Gs)[V]) {
  Vec<X, V> gxo;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float gvr = cell_math::round_to<S>(Gv[k]);
    const float gir = cell_math::round_to<S>(Gi[k]);
    const float d = __fadd_rn(__fsub_rn(0.0f, v[k]), i[k]);
    const float s = __fsub_rn(__fmaf_rn(d, fm[k], v[k]), 1.0f);
    const float gin = active ? gir : 0.0f;
    float gv, gi, g_vdec;
    const float gxv =
        cell_step_vjp<kLIF>(s, to_f32(g.a[k]), active ? gvr : 0.0f, gin,
                            fm[k], fs[k], alpha, gv, gi, g_vdec);
    Gm[k] = __fadd_rn(Gm[k], __fmul_rn(g_vdec, d));
    Gs[k] = __fadd_rn(Gs[k], __fmul_rn(gin, i[k]));
    gxo.a[k] = from_f32<X>(gxv);
    gv = cell_math::round_to<S>(gv);
    gi = cell_math::round_to<S>(gi);
    Gv[k] = active ? gv : __fadd_rn(gv, gvr);
    Gi[k] = active ? gi : __fadd_rn(gi, gir);
  }
  return gxo;
}

// V elements of two state-typed arrays, widened to fp32.
template <typename S, int V>
__device__ __forceinline__ void load_state(const S* v, const S* i,
                                           float (&v_out)[V],
                                           float (&i_out)[V]) {
  const Vec<S, V> vs = *reinterpret_cast<const Vec<S, V>*>(v);
  const Vec<S, V> is = *reinterpret_cast<const Vec<S, V>*>(i);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    v_out[k] = to_f32(vs.a[k]);
    i_out[k] = to_f32(is.a[k]);
  }
}

// One LIF (or PLIF) step forward of a thread's V elements, the state
// rounded to its storage type and held for a frozen step, as the forward
// kernel.
template <typename X, typename S, int V>
__device__ __forceinline__ void lif_advance(const Vec<X, V>& xc, bool active,
                                            float (&v)[V], float (&i)[V],
                                            const float (&fm)[V],
                                            const float (&fs)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float v_new = v[k], i_new = i[k];
    cell_math::cell_step<kLIF>(to_f32(xc.a[k]), v_new, i_new, fm[k], fs[k]);
    if (active) {
      v[k] = cell_math::round_to<S>(v_new);
      i[k] = cell_math::round_to<S>(i_new);
    }
  }
}

// LI over any T, and LIF and PLIF at T <= 1 (the per-step schedule's
// every launch): one reverse pass over gz. LI's gradient depends on
// neither the state nor x; LIF's single step reads s of (v0, i0), PLIF's
// (v0, i0) itself, and PLIF writes its factor sums to gcm, gcs.
template <int CELL, typename X, typename S, int V>
__global__ void __launch_bounds__(256) temporal_cell_bwd_kernel(
    const X* __restrict__ x, const S* __restrict__ v0,
    const S* __restrict__ i0, const X* __restrict__ gz,
    const S* __restrict__ gvT, const S* __restrict__ giT,
    X* __restrict__ gx, S* __restrict__ gv0, S* __restrict__ gi0,
    float* __restrict__ gcm, float* __restrict__ gcs, int T, int64_t M,
    int start, Factors f, float alpha) {
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (base >= M) return;

  float fm[V], fs[V];
  load_factors<CELL, V>(f, base, fm, fs);
  float s[V] = {}, v[V] = {}, i[V] = {};
  if (CELL != kLI) {
    load_state<S, V>(v0 + base, i0 + base, v, i);
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = lif_s(v[k], i[k], fm[k]);
  }
  float Gv[V], Gi[V], Gm[V] = {}, Gs[V] = {};
  load_state<S, V>(gvT + base, giT + base, Gv, Gi);
  for (int t = T - 1; t >= 0; --t) {
    const Vec<X, V> gzc =
        *reinterpret_cast<const Vec<X, V>*>(gz + t * M + base);
    Vec<X, V> gxo;
    if constexpr (CELL == kPLIF) {
      gxo = plif_bwd_step<X, S, V>(v, i, gzc, t >= start, Gv, Gi, fm, fs,
                                   alpha, Gm, Gs);
    } else {
      gxo = bwd_step<CELL, X, S, V>(s, gzc, t >= start, Gv, Gi, fm, fs,
                                    alpha);
    }
    *reinterpret_cast<Vec<X, V>*>(gx + t * M + base) = gxo;
  }
  if (CELL == kPLIF) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      gcm[base + k] = Gm[k];
      gcs[base + k] = Gs[k];
    }
  }

  Vec<S, V> gvs, gis;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    gvs.a[k] = from_f32<S>(Gv[k]);
    gis.a[k] = from_f32<S>(Gi[k]);
  }
  *reinterpret_cast<Vec<S, V>*>(gv0 + base) = gvs;
  *reinterpret_cast<Vec<S, V>*>(gi0 + base) = gis;
}

// LIF and PLIF at T >= 2, by chunked recompute. The steps are cut into K =
// ceil(T / C) chunks of C (the last may be shorter). Pass 1 runs the
// forward from (v0, i0) over chunks 0 .. K-2 and keeps the state entering
// chunks 1 .. K-2 (K-2 checkpoints a state, in the storage type, which
// holds them exactly): in a column of shared memory that is the thread's
// own, or in rows [2, K-2, M] of global memory (ckpt); the state entering
// chunk K-1 stays in registers. Pass 2 walks the chunks from last to
// first: it issues the chunk's loads of x and gz at once (2C loads in
// flight a thread), re-runs the forward from the chunk's checkpoint,
// keeping each step's s in registers (C is a template parameter and the
// chunk's loops are unrolled, so s[C][V] is indexed at compile time),
// then walks the chunk backward. PLIF keeps each step's entering state
// (v, i) instead of s, twice the registers (so shorter chunks), and sums
// the factors' cotangents on the way. Every value is computed by the
// same ops in the same order as in a run that kept every state, so the
// result is bit-equal to it.
template <int CELL, int C, typename X, typename S, int V>
__global__ void __launch_bounds__(256) temporal_cell_bwd_chunked_kernel(
    const X* __restrict__ x, const S* __restrict__ v0,
    const S* __restrict__ i0, const X* __restrict__ gz,
    const S* __restrict__ gvT, const S* __restrict__ giT,
    X* __restrict__ gx, S* __restrict__ gv0, S* __restrict__ gi0, S* ckpt,
    float* __restrict__ gcm, float* __restrict__ gcs, int T, int64_t M,
    int start, Factors f, float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  using XV = Vec<X, V>;
  using SV = Vec<S, V>;
  const int64_t gid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t base = gid * V;
  if (base >= M) return;

  const int K = (T + C - 1) / C;
  // checkpoint r of state h (0: v, 1: i) is slot[r * row + h * half]
  SV* slot;
  int64_t row, half;
  if (ckpt == nullptr) {
    slot = reinterpret_cast<SV*>(smem) + threadIdx.x;
    half = blockDim.x;
    row = 2 * half;
  } else {
    slot = reinterpret_cast<SV*>(ckpt) + gid;
    row = M / V;
    half = static_cast<int64_t>(K - 2) * row;
  }

  float fm[V], fs[V];
  load_factors<CELL, V>(f, base, fm, fs);
  float v[V], i[V];
  load_state<S, V>(v0 + base, i0 + base, v, i);
  // pass 1: the forward over the full chunks 0 .. K-2
  for (int k = 0; k + 1 < K; ++k) {
    if (k > 0) {
      SV vs, is;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        vs.a[e] = from_f32<S>(v[e]);
        is.a[e] = from_f32<S>(i[e]);
      }
      slot[(k - 1) * row] = vs;
      slot[(k - 1) * row + half] = is;
    }
    XV xc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      xc[j] = *reinterpret_cast<const XV*>(
          x + static_cast<int64_t>(k * C + j) * M + base);
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      lif_advance<X, S, V>(xc[j], k * C + j >= start, v, i, fm, fs);
    }
  }

  // pass 2: the chunks from last to first, the carried cotangents in fp32
  float Gv[V], Gi[V], Gm[V] = {}, Gs[V] = {};
  load_state<S, V>(gvT + base, giT + base, Gv, Gi);
  for (int k = K - 1; k >= 0; --k) {
    const int t0 = k * C;
    const int L = min(C, T - t0);
    if (k == 0 && K > 1) {
      load_state<S, V>(v0 + base, i0 + base, v, i);
    } else if (k < K - 1) {
      const SV vs = slot[(k - 1) * row];
      const SV is = slot[(k - 1) * row + half];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[e] = to_f32(vs.a[e]);
        i[e] = to_f32(is.a[e]);
      }
    }
    XV xc[C], gc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < L) {
        const int64_t off = static_cast<int64_t>(t0 + j) * M + base;
        xc[j] = *reinterpret_cast<const XV*>(x + off);
        gc[j] = *reinterpret_cast<const XV*>(gz + off);
      }
    }
    // LIF: s of each step; PLIF: the state (v, i) entering each step
    float s[C][V], vs[CELL == kPLIF ? C : 1][V], is[CELL == kPLIF ? C : 1][V];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < L) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if constexpr (CELL == kPLIF) {
            vs[j][e] = v[e];
            is[j][e] = i[e];
          } else {
            s[j][e] = lif_s(v[e], i[e], fm[e]);
          }
        }
        if (j + 1 < L) {
          lif_advance<X, S, V>(xc[j], t0 + j >= start, v, i, fm, fs);
        }
      }
    }
#pragma unroll
    for (int j = C - 1; j >= 0; --j) {
      if (j < L) {
        XV gxo;
        if constexpr (CELL == kPLIF) {
          gxo = plif_bwd_step<X, S, V>(vs[j], is[j], gc[j], t0 + j >= start,
                                       Gv, Gi, fm, fs, alpha, Gm, Gs);
        } else {
          gxo = bwd_step<kLIF, X, S, V>(s[j], gc[j], t0 + j >= start, Gv, Gi,
                                        fm, fs, alpha);
        }
        *reinterpret_cast<XV*>(gx + static_cast<int64_t>(t0 + j) * M +
                               base) = gxo;
      }
    }
  }
  if (CELL == kPLIF) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      gcm[base + e] = Gm[e];
      gcs[base + e] = Gs[e];
    }
  }

  SV gvs, gis;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    gvs.a[e] = from_f32<S>(Gv[e]);
    gis.a[e] = from_f32<S>(Gi[e]);
  }
  *reinterpret_cast<SV*>(gv0 + base) = gvs;
  *reinterpret_cast<SV*>(gi0 + base) = gis;
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int CELL, typename X, typename S>
int launch(const void* x, const void* v0, const void* i0, void* z, void* vT,
           void* iT, int T, int64_t M, int start, const Factors& f,
           cudaStream_t stream) {
  // 16-byte loads of x when the flat size and every pointer allow it
  constexpr int V = 16 / sizeof(X);
  const bool vec = M % V == 0 && aligned(x, 16) && aligned(z, 16) &&
                   aligned(v0, V * sizeof(S)) && aligned(i0, V * sizeof(S)) &&
                   aligned(vT, V * sizeof(S)) && aligned(iT, V * sizeof(S));
  const int threads = 256;
  const int64_t work = vec ? M / V : M;
  const int64_t blocks = (work + threads - 1) / threads;
  const X* xp = static_cast<const X*>(x);
  const S* vp = static_cast<const S*>(v0);
  const S* ip = static_cast<const S*>(i0);
  X* zp = static_cast<X*>(z);
  S* vtp = static_cast<S*>(vT);
  S* itp = static_cast<S*>(iT);
  if (vec) {
    temporal_cell_kernel<CELL, X, S, V><<<blocks, threads, 0, stream>>>(
        xp, vp, ip, zp, vtp, itp, T, M, start, f);
  } else {
    temporal_cell_kernel<CELL, X, S, 1><<<blocks, threads, 0, stream>>>(
        xp, vp, ip, zp, vtp, itp, T, M, start, f);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int CELL, typename X>
int launch_state(int state_dtype, const void* x, const void* v0,
                 const void* i0, void* z, void* vT, void* iT, int T,
                 int64_t M, int start, const Factors& f, cudaStream_t s) {
  switch (state_dtype) {
    case 0:
      return launch<CELL, X, float>(x, v0, i0, z, vT, iT, T, M, start, f, s);
    case 1:
      return launch<CELL, X, __nv_bfloat16>(x, v0, i0, z, vT, iT, T, M, start,
                                            f, s);
    case 2:
      return launch<CELL, X, E5M2>(x, v0, i0, z, vT, iT, T, M, start, f, s);
    case 3:
      return launch<CELL, X, E4M3>(x, v0, i0, z, vT, iT, T, M, start, f, s);
  }
  return -1;
}

template <int CELL>
int launch_x(int x_dtype, int state_dtype, const void* x, const void* v0,
             const void* i0, void* z, void* vT, void* iT, int T, int64_t M,
             int start, const Factors& f, cudaStream_t s) {
  switch (x_dtype) {
    case 0:
      return launch_state<CELL, float>(state_dtype, x, v0, i0, z, vT, iT, T,
                                       M, start, f, s);
    case 1:
      return launch_state<CELL, __nv_bfloat16>(state_dtype, x, v0, i0, z, vT,
                                               iT, T, M, start, f, s);
  }
  return -1;
}

// The backward's pointers, in the order of the C entry points (gcm, gcs:
// PLIF's factor sums, null for LIF and LI).
struct BwdArgs {
  const void *x, *v0, *i0, *gz, *gvT, *giT;
  void *gx, *gv0, *gi0, *ckpt;
  float *gcm, *gcs;
};

// The launch plan (ops/cuda_kernels.py's CellBwdPlan): 16 bytes of x a
// thread or one element (vec); for the chunked kernel, chunk C, threads
// a CTA and the dynamic shared memory that holds the checkpoints (0 when
// they are in global memory).
struct BwdPlan {
  int chunk, threads, vec, smem;
};

constexpr int kMaxSmem = 232448;  // 227 KB, the most a CTA can have

// The chunks built for V elements a thread: LIF's, a thread's s values,
// C * V, at most 48 on the vector paths (beyond it ptxas spills at the
// launch bounds' 255 registers), every chunk on the scalar path
// (ops/cuda_kernels.py's CELL_BWD_MAX_S); PLIF's, one chunk a width,
// its entering states 2 * C * V values a thread (ops/cuda_kernels.py's
// PLIF_BWD_CHUNK).
constexpr int plif_chunk(int V) { return V == 1 ? 8 : (V == 4 ? 4 : 2); }
constexpr bool chunk_built(int CELL, int C, int V) {
  return CELL == kPLIF ? C == plif_chunk(V) : (V == 1 || C * V <= 48);
}

template <int CELL, int C, typename X, typename S, int V>
int launch_chunked(const BwdArgs& a, const BwdPlan& p, int T, int64_t M,
                   int start, const Factors& f, float alpha,
                   cudaStream_t stream) {
  if constexpr (!chunk_built(CELL, C, V)) {
    return -1;
  } else {
    auto kernel = temporal_cell_bwd_chunked_kernel<CELL, C, X, S, V>;
    if (p.smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int64_t blocks = (M / V + p.threads - 1) / p.threads;
    kernel<<<blocks, p.threads, p.smem, stream>>>(
        static_cast<const X*>(a.x), static_cast<const S*>(a.v0),
        static_cast<const S*>(a.i0), static_cast<const X*>(a.gz),
        static_cast<const S*>(a.gvT), static_cast<const S*>(a.giT),
        static_cast<X*>(a.gx), static_cast<S*>(a.gv0),
        static_cast<S*>(a.gi0), static_cast<S*>(a.ckpt), a.gcm, a.gcs, T, M,
        start, f, alpha);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int CELL, typename X, typename S, int V>
int launch_chunk(const BwdArgs& a, const BwdPlan& p, int T, int64_t M,
                 int start, const Factors& f, float alpha, cudaStream_t s) {
  switch (p.chunk) {
#define CHUNK(C)                                                            \
  case C:                                                                   \
    return launch_chunked<CELL, C, X, S, V>(a, p, T, M, start, f, alpha, s);
    CHUNK(2) CHUNK(4) CHUNK(6) CHUNK(8) CHUNK(12) CHUNK(16)
#undef CHUNK
  }
  return -1;
}

template <int CELL, typename X, typename S>
int launch_bwd(const BwdArgs& a, const BwdPlan& p, int T, int64_t M,
               int start, const Factors& f, float alpha,
               cudaStream_t stream) {
  // 16-byte loads of x and gz when the plan asks for them; the entry
  // point refuses a plan that the flat size or a pointer does not allow
  constexpr int V = 16 / sizeof(X);
  const size_t sv = V * sizeof(S);
  if (p.vec && !(M % V == 0 && aligned(a.x, 16) && aligned(a.gz, 16) &&
                 aligned(a.gx, 16) && aligned(a.v0, sv) &&
                 aligned(a.i0, sv) && aligned(a.gvT, sv) &&
                 aligned(a.giT, sv) && aligned(a.gv0, sv) &&
                 aligned(a.gi0, sv) && aligned(a.ckpt, sv) &&
                 aligned(a.gcm, 4 * V) && aligned(a.gcs, 4 * V))) {
    return -1;
  }
  // LIF and PLIF at T >= 2 (LI never recomputes: no chunked instance)
  if constexpr (CELL != kLI) {
    if (T >= 2) {
      // the plan's checkpoints: K - 2 rows a state, in shared memory
      // (smem bytes) or in the global rows ckpt
      const int chunks = (T + p.chunk - 1) / p.chunk;
      const int rows = chunks > 2 ? chunks - 2 : 0;
      const int64_t want = static_cast<int64_t>(p.threads) * rows * 2 *
                           (p.vec ? V : 1) * sizeof(S);
      const bool global = a.ckpt != nullptr;
      if ((p.threads != 128 && p.threads != 256) ||
          p.smem != (global ? 0 : want) || p.smem > kMaxSmem ||
          (global && rows == 0)) {
        return -1;
      }
      return p.vec ? launch_chunk<CELL, X, S, V>(a, p, T, M, start, f,
                                                 alpha, stream)
                   : launch_chunk<CELL, X, S, 1>(a, p, T, M, start, f,
                                                 alpha, stream);
    }
  }
  const int threads = 256;
  const int64_t work = p.vec ? M / V : M;
  const int64_t blocks = (work + threads - 1) / threads;
  auto go = [&](auto kernel) {
    kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const X*>(a.x), static_cast<const S*>(a.v0),
        static_cast<const S*>(a.i0), static_cast<const X*>(a.gz),
        static_cast<const S*>(a.gvT), static_cast<const S*>(a.giT),
        static_cast<X*>(a.gx), static_cast<S*>(a.gv0), static_cast<S*>(a.gi0),
        a.gcm, a.gcs, T, M, start, f, alpha);
  };
  if (p.vec) {
    go(temporal_cell_bwd_kernel<CELL, X, S, V>);
  } else {
    go(temporal_cell_bwd_kernel<CELL, X, S, 1>);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int CELL, typename X>
int launch_bwd_state(int state_dtype, const BwdArgs& a, const BwdPlan& p,
                     int T, int64_t M, int start, const Factors& f,
                     float alpha, cudaStream_t s) {
  switch (state_dtype) {
    case 0:
      return launch_bwd<CELL, X, float>(a, p, T, M, start, f, alpha, s);
    case 1:
      return launch_bwd<CELL, X, __nv_bfloat16>(a, p, T, M, start, f, alpha,
                                                s);
    case 2:
      return launch_bwd<CELL, X, E5M2>(a, p, T, M, start, f, alpha, s);
    case 3:
      return launch_bwd<CELL, X, E4M3>(a, p, T, M, start, f, alpha, s);
  }
  return -1;
}

template <int CELL>
int launch_bwd_x(int x_dtype, int state_dtype, const BwdArgs& a,
                 const BwdPlan& p, int T, int64_t M, int start,
                 const Factors& f, float alpha, cudaStream_t s) {
  switch (x_dtype) {
    case 0:
      return launch_bwd_state<CELL, float>(state_dtype, a, p, T, M, start, f,
                                           alpha, s);
    case 1:
      return launch_bwd_state<CELL, __nv_bfloat16>(state_dtype, a, p, T, M,
                                                   start, f, alpha, s);
  }
  return -1;
}

}  // namespace
