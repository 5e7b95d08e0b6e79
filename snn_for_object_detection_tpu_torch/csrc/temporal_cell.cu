// Whole-layer LIF / LI cell over T time steps, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `temporal_cell_seq`
// (snn_for_object_detection_tpu/ops/pallas_kernels.py: `_temporal_kernel`
// under `_temporal_pallas_core`'s pallas_call). Same function:
//   in:  x[T, M] (fp32 or bf16), v0[M], i0[M] (fp32, bf16 or fp8 e5m2)
//   out: z[T, M] in x's type, v_T[M], i_T[M] in the state type
// with fp32 update math, the state re-quantized to its storage type
// every step, and the truncation gate: for t < start the state stays
// frozen while z[t] is still emitted from it.
//
// What bounds it: memory. Each element-step reads x[t] once and writes
// z[t] once and does about ten flops, far below the card's ~20 flops
// per byte, so the least time is (bytes of x + z + states) / 3.35 TB/s.
//
// Design. The TPU kernel blocked rows into VMEM and walked t as the
// innermost sequential grid axis with (v, i) in VMEM scratch. Here the
// time loop runs inside each thread instead: one thread owns VEC
// neighbouring state elements, keeps (v, i) in registers for all T
// steps, reads x[t] with one 16-byte load and writes z[t] once, so a
// warp touches consecutive addresses of the flat per-step index and
// the state never goes back to memory between t = 0 and t = T-1. The
// next step's x is loaded before the current step's math to keep a
// second load in flight. The GSPMD partitioning rule of the TPU kernel
// (`_partitioned_temporal`) has no counterpart on one card.
//
// Rounding matches the plain PyTorch version (ops/neurons.py); the
// update and the storage conversions are in cell_math.cuh, shared with
// spiking_conv.cu.
//
// The backward (temporal_cell_seq_bwd_launch) is the VJP of the same
// function: the counterpart of the JAX custom VJP `_temporal_bwd`, which
// recomputes through a lax.scan (`_temporal_scan_reference`); its plain
// version is autograd through ops/cuda_kernels.py's
// temporal_cell_seq_reference. Given the cotangents gz[T, M] (x's type)
// and gvT, giT (state type) it returns gx[T, M], gv0 and gi0, with the
// SuperSpike surrogate (alpha = 100) on v_dec - v_th, the reset gate
// detached, and the truncation gate: a frozen step's state cotangent
// passes to the old state, plus what its output sends back. The carried
// state cotangent is rounded to the state type at every step, as the
// JAX scan's astype pair and the plain version round it.
//
// Design: one thread owns V state elements, as in the forward. LIF's
// gradient depends on the state, through the spike and the surrogate,
// only by s = v_dec - v_th of each step, and the state entering a step
// is a deterministic function of an earlier state and the x between, so
// the kernel recomputes it in chunks of C steps instead of keeping it:
// pass 1 re-runs the forward from (v0, i0) with the same update (its
// spikes are bit-equal to the forward kernel's) and keeps only the state
// entering each chunk, ceil(T / C) - 2 checkpoints a state, in shared
// memory where they fit (a column a thread: no synchronisation) or in
// global rows the wrapper allocates; pass 2 walks the chunks from last
// to first, re-runs each chunk's forward from its checkpoint with s in
// registers and walks it backward. The launch plan (C, checkpoint
// placement, threads) is ops/cuda_kernels.py's cell_bwd_plan. At T = 1,
// the per-step schedule's case, there is no recompute. LI is linear:
// its gradient does not depend on the state or on x, so it is one pass
// over gz. The sums run in the order autograd sums the plain version's
// gradients, so the two are bit-equal. What bounds it: memory, as the
// forward. The least bytes are gz read and gx written at every step, the
// cotangents of the states once, and for LIF x and (v0, i0) too; pass 1
// reads x a second time (all but the last chunk), so LIF moves about 4
// sequences of [T, M] against the bound's 3, plus the checkpoints when
// they are global; LI 2 against 2. Pass 2 keeps 2C loads in flight a
// thread.

#include "cell_math.cuh"

namespace {

using cell_math::E5M2;
using cell_math::from_f32;
using cell_math::kLI;
using cell_math::kLIF;
using cell_math::to_f32;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T a[N];
};

template <int CELL, typename X, typename S, int V>
__global__ void __launch_bounds__(256) temporal_cell_kernel(
    const X* __restrict__ x, const S* __restrict__ v0,
    const S* __restrict__ i0, X* __restrict__ z, S* __restrict__ vT,
    S* __restrict__ iT, int T, int64_t M, int start, float c_mem,
    float c_syn) {
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (base >= M) return;

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
                                                   i_new, c_mem, c_syn);
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
// Returns the cotangents of the step's input state in (gv, gi) and of x.
template <int CELL>
__device__ __forceinline__ float cell_step_vjp(float s, float g, float gvn,
                                               float gin, float c_mem,
                                               float c_syn, float alpha,
                                               float& gv, float& gi) {
  float g_vdec;
  if (CELL == kLIF) {
    const float q = __fadd_rn(__fmul_rn(alpha, fabsf(s)), 1.0f);
    const float sg = __fdiv_rn(g, __fmul_rn(q, q));
    g_vdec = __fadd_rn(s > 0.0f ? 0.0f : gvn, sg);
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
                                              float (&Gi)[V], float c_mem,
                                              float c_syn, float alpha) {
  Vec<X, V> gxo;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float gvr = cell_math::round_to<S>(Gv[k]);
    const float gir = cell_math::round_to<S>(Gi[k]);
    float gv, gi;
    const float gxv = cell_step_vjp<CELL>(
        s[k], to_f32(g.a[k]), active ? gvr : 0.0f, active ? gir : 0.0f,
        c_mem, c_syn, alpha, gv, gi);
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

// One LIF step forward of a thread's V elements, the state rounded to
// its storage type and held for a frozen step, as the forward kernel.
template <typename X, typename S, int V>
__device__ __forceinline__ void lif_advance(const Vec<X, V>& xc, bool active,
                                            float (&v)[V], float (&i)[V],
                                            float c_mem, float c_syn) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float v_new = v[k], i_new = i[k];
    cell_math::cell_step<kLIF>(to_f32(xc.a[k]), v_new, i_new, c_mem, c_syn);
    if (active) {
      v[k] = cell_math::round_to<S>(v_new);
      i[k] = cell_math::round_to<S>(i_new);
    }
  }
}

// LI over any T, and LIF at T <= 1 (the per-step schedule's every
// launch): one reverse pass over gz. LI's gradient depends on neither
// the state nor x; LIF's single step reads s of (v0, i0).
template <int CELL, typename X, typename S, int V>
__global__ void __launch_bounds__(256) temporal_cell_bwd_kernel(
    const X* __restrict__ x, const S* __restrict__ v0,
    const S* __restrict__ i0, const X* __restrict__ gz,
    const S* __restrict__ gvT, const S* __restrict__ giT,
    X* __restrict__ gx, S* __restrict__ gv0, S* __restrict__ gi0, int T,
    int64_t M, int start, float c_mem, float c_syn, float alpha) {
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (base >= M) return;

  float s[V] = {};
  if (CELL == kLIF) {
    float v[V], i[V];
    load_state<S, V>(v0 + base, i0 + base, v, i);
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = lif_s(v[k], i[k], c_mem);
  }
  float Gv[V], Gi[V];
  load_state<S, V>(gvT + base, giT + base, Gv, Gi);
  for (int t = T - 1; t >= 0; --t) {
    const Vec<X, V> gzc =
        *reinterpret_cast<const Vec<X, V>*>(gz + t * M + base);
    *reinterpret_cast<Vec<X, V>*>(gx + t * M + base) = bwd_step<CELL, X, S, V>(
        s, gzc, t >= start, Gv, Gi, c_mem, c_syn, alpha);
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

// LIF at T >= 2, by chunked recompute. The steps are cut into K =
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
// then walks the chunk backward. Every value is computed by the same
// ops in the same order as in a run that kept every state, so the
// result is bit-equal to it.
template <int C, typename X, typename S, int V>
__global__ void __launch_bounds__(256) temporal_cell_bwd_chunked_kernel(
    const X* __restrict__ x, const S* __restrict__ v0,
    const S* __restrict__ i0, const X* __restrict__ gz,
    const S* __restrict__ gvT, const S* __restrict__ giT,
    X* __restrict__ gx, S* __restrict__ gv0, S* __restrict__ gi0, S* ckpt,
    int T, int64_t M, int start, float c_mem, float c_syn, float alpha) {
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
      lif_advance<X, S, V>(xc[j], k * C + j >= start, v, i, c_mem, c_syn);
    }
  }

  // pass 2: the chunks from last to first, the carried cotangents in fp32
  float Gv[V], Gi[V];
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
    float s[C][V];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < L) {
#pragma unroll
        for (int e = 0; e < V; ++e) s[j][e] = lif_s(v[e], i[e], c_mem);
        if (j + 1 < L) {
          lif_advance<X, S, V>(xc[j], t0 + j >= start, v, i, c_mem, c_syn);
        }
      }
    }
#pragma unroll
    for (int j = C - 1; j >= 0; --j) {
      if (j < L) {
        *reinterpret_cast<XV*>(gx + static_cast<int64_t>(t0 + j) * M +
                               base) =
            bwd_step<kLIF, X, S, V>(s[j], gc[j], t0 + j >= start, Gv, Gi,
                                    c_mem, c_syn, alpha);
      }
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
           void* iT, int T, int64_t M, int start, float c_mem, float c_syn,
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
        xp, vp, ip, zp, vtp, itp, T, M, start, c_mem, c_syn);
  } else {
    temporal_cell_kernel<CELL, X, S, 1><<<blocks, threads, 0, stream>>>(
        xp, vp, ip, zp, vtp, itp, T, M, start, c_mem, c_syn);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int CELL, typename X>
int launch_state(int state_dtype, const void* x, const void* v0,
                 const void* i0, void* z, void* vT, void* iT, int T,
                 int64_t M, int start, float c_mem, float c_syn,
                 cudaStream_t s) {
  switch (state_dtype) {
    case 0:
      return launch<CELL, X, float>(x, v0, i0, z, vT, iT, T, M, start, c_mem,
                                    c_syn, s);
    case 1:
      return launch<CELL, X, __nv_bfloat16>(x, v0, i0, z, vT, iT, T, M, start,
                                            c_mem, c_syn, s);
    case 2:
      return launch<CELL, X, E5M2>(x, v0, i0, z, vT, iT, T, M, start, c_mem,
                                   c_syn, s);
  }
  return -1;
}

template <int CELL>
int launch_x(int x_dtype, int state_dtype, const void* x, const void* v0,
             const void* i0, void* z, void* vT, void* iT, int T, int64_t M,
             int start, float c_mem, float c_syn, cudaStream_t s) {
  switch (x_dtype) {
    case 0:
      return launch_state<CELL, float>(state_dtype, x, v0, i0, z, vT, iT, T,
                                       M, start, c_mem, c_syn, s);
    case 1:
      return launch_state<CELL, __nv_bfloat16>(state_dtype, x, v0, i0, z, vT,
                                               iT, T, M, start, c_mem, c_syn,
                                               s);
  }
  return -1;
}

// The backward's pointers, in the order of the C entry point.
struct BwdArgs {
  const void *x, *v0, *i0, *gz, *gvT, *giT;
  void *gx, *gv0, *gi0, *ckpt;
};

// The launch plan (ops/cuda_kernels.py's CellBwdPlan): 16 bytes of x a
// thread or one element (vec); for the chunked kernel, chunk C, threads
// a CTA and the dynamic shared memory that holds the checkpoints (0 when
// they are in global memory).
struct BwdPlan {
  int chunk, threads, vec, smem;
};

constexpr int kMaxSmem = 232448;  // 227 KB, the most a CTA can have

// The chunks built for V elements a thread: a thread's s values, C * V,
// at most 48 on the vector paths (beyond it ptxas spills at the launch
// bounds' 255 registers), every chunk on the scalar path
// (ops/cuda_kernels.py's CELL_BWD_MAX_S).
constexpr bool chunk_built(int C, int V) { return V == 1 || C * V <= 48; }

template <int C, typename X, typename S, int V>
int launch_chunked(const BwdArgs& a, const BwdPlan& p, int T, int64_t M,
                   int start, float c_mem, float c_syn, float alpha,
                   cudaStream_t stream) {
  if constexpr (!chunk_built(C, V)) {
    return -1;
  } else {
    auto kernel = temporal_cell_bwd_chunked_kernel<C, X, S, V>;
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
        static_cast<S*>(a.gi0), static_cast<S*>(a.ckpt), T, M, start,
        c_mem, c_syn, alpha);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename X, typename S, int V>
int launch_chunk(const BwdArgs& a, const BwdPlan& p, int T, int64_t M,
                 int start, float c_mem, float c_syn, float alpha,
                 cudaStream_t s) {
  switch (p.chunk) {
#define CHUNK(C)                                                          \
  case C:                                                                 \
    return launch_chunked<C, X, S, V>(a, p, T, M, start, c_mem, c_syn,    \
                                      alpha, s);
    CHUNK(2) CHUNK(4) CHUNK(6) CHUNK(8) CHUNK(12) CHUNK(16)
#undef CHUNK
  }
  return -1;
}

template <int CELL, typename X, typename S>
int launch_bwd(const BwdArgs& a, const BwdPlan& p, int T, int64_t M,
               int start, float c_mem, float c_syn, float alpha,
               cudaStream_t stream) {
  // 16-byte loads of x and gz when the plan asks for them; the entry
  // point refuses a plan that the flat size or a pointer does not allow
  constexpr int V = 16 / sizeof(X);
  const size_t sv = V * sizeof(S);
  const bool chunked = CELL == kLIF && T >= 2;
  if (p.vec && !(M % V == 0 && aligned(a.x, 16) && aligned(a.gz, 16) &&
                 aligned(a.gx, 16) && aligned(a.v0, sv) &&
                 aligned(a.i0, sv) && aligned(a.gvT, sv) &&
                 aligned(a.giT, sv) && aligned(a.gv0, sv) &&
                 aligned(a.gi0, sv) && aligned(a.ckpt, sv))) {
    return -1;
  }
  if (chunked) {
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
    return p.vec ? launch_chunk<X, S, V>(a, p, T, M, start, c_mem, c_syn,
                                         alpha, stream)
                 : launch_chunk<X, S, 1>(a, p, T, M, start, c_mem, c_syn,
                                         alpha, stream);
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
        T, M, start, c_mem, c_syn, alpha);
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
                     int T, int64_t M, int start, float c_mem, float c_syn,
                     float alpha, cudaStream_t s) {
  switch (state_dtype) {
    case 0:
      return launch_bwd<CELL, X, float>(a, p, T, M, start, c_mem, c_syn,
                                        alpha, s);
    case 1:
      return launch_bwd<CELL, X, __nv_bfloat16>(a, p, T, M, start, c_mem,
                                                c_syn, alpha, s);
    case 2:
      return launch_bwd<CELL, X, E5M2>(a, p, T, M, start, c_mem, c_syn,
                                       alpha, s);
  }
  return -1;
}

template <int CELL>
int launch_bwd_x(int x_dtype, int state_dtype, const BwdArgs& a,
                 const BwdPlan& p, int T, int64_t M, int start, float c_mem,
                 float c_syn, float alpha, cudaStream_t s) {
  switch (x_dtype) {
    case 0:
      return launch_bwd_state<CELL, float>(state_dtype, a, p, T, M, start,
                                           c_mem, c_syn, alpha, s);
    case 1:
      return launch_bwd_state<CELL, __nv_bfloat16>(state_dtype, a, p, T, M,
                                                   start, c_mem, c_syn,
                                                   alpha, s);
  }
  return -1;
}

}  // namespace

// C entry point (loaded with ctypes). Type codes: 0 fp32, 1 bf16,
// 2 fp8 e5m2 (state only); cell 0 = LIF, 1 = LI. Returns 0 on success,
// -1 for an unsupported argument, else the cudaError_t of the launch.
extern "C" int temporal_cell_seq_launch(const void* x, const void* v0,
                                        const void* i0, void* z, void* vT,
                                        void* iT, long long T, long long M,
                                        int start, int cell, int x_dtype,
                                        int state_dtype, float c_mem,
                                        float c_syn, void* stream) {
  if (T < 0 || T > 0x7fffffff || M < 0) return -1;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(T);
  if (cell == kLIF) {
    return launch_x<kLIF>(x_dtype, state_dtype, x, v0, i0, z, vT, iT, t, M,
                          start, c_mem, c_syn, s);
  }
  if (cell == kLI) {
    return launch_x<kLI>(x_dtype, state_dtype, x, v0, i0, z, vT, iT, t, M,
                         start, c_mem, c_syn, s);
  }
  return -1;
}

// C entry point of the backward. LIF at T >= 2 runs the chunked kernel
// under the plan (chunk, threads, smem); its checkpoints are in shared
// memory when ckpt is null, else in ckpt, rows [2, ceil(T / chunk) - 2,
// M] of the state type. vec: 16-byte loads of x (refused where the flat
// size or a pointer does not allow them). LI and LIF at T <= 1 take
// neither checkpoints nor the chunk. Type and cell codes and return
// values as above.
extern "C" int temporal_cell_seq_bwd_launch(
    const void* x, const void* v0, const void* i0, const void* gz,
    const void* gvT, const void* giT, void* gx, void* gv0, void* gi0,
    void* ckpt, long long T, long long M, int start, int cell, int x_dtype,
    int state_dtype, float c_mem, float c_syn, float alpha, int chunk,
    int threads, int vec, int smem, void* stream) {
  if (T < 0 || T > 0x7fffffff || M < 0) return -1;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(T);
  const BwdArgs a{x, v0, i0, gz, gvT, giT, gx, gv0, gi0, ckpt};
  const BwdPlan p{chunk, threads, vec, smem};
  if (cell == kLIF) {
    return launch_bwd_x<kLIF>(x_dtype, state_dtype, a, p, t, M, start, c_mem,
                              c_syn, alpha, s);
  }
  if (cell == kLI) {
    return launch_bwd_x<kLI>(x_dtype, state_dtype, a, p, t, M, start, c_mem,
                             c_syn, alpha, s);
  }
  return -1;
}
