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
// Design: one thread owns V state elements, as in the forward. For LIF
// (whose gradient depends on the state through the spike and the
// surrogate) pass 1 re-runs the forward from (v0, i0) with the same
// update, so its spikes are bit-equal to the forward kernel's, and
// writes the state entering each step t >= 1 to a workspace [T-1, M]
// per state; pass 2 walks t from T-1 down to 0 reading it back (the
// same thread wrote it: no synchronisation). At T = 1, the per-step
// schedule's case, there is no workspace. LI is linear: its gradient
// does not depend on the state or on x, so it is one pass over gz.
// The sums run in the order autograd sums the plain version's
// gradients, so the two are bit-equal. What bounds it: memory, as the
// forward. The least bytes are gz read and gx written at every step, the
// cotangents of the states once, and for LIF x and (v0, i0) too; pass 1
// reads x again and both passes stream the workspace, so LIF moves about
// 7 sequences of [T, M] against the bound's 3 (at fp32 states), LI 2
// against 2.

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

// One step's VJP for one element. (v, i): the state entering the step
// (LIF only); g: the output's cotangent; (gvn, gin): the new state's.
// Returns the cotangents of the step's input state in (gv, gi) and of x.
template <int CELL>
__device__ __forceinline__ float cell_step_vjp(float v, float i, float g,
                                               float gvn, float gin,
                                               float c_mem, float c_syn,
                                               float alpha, float& gv,
                                               float& gi) {
  float g_vdec;
  if (CELL == kLIF) {
    const float d = __fadd_rn(__fsub_rn(0.0f, v), i);
    const float s = __fsub_rn(__fmaf_rn(d, c_mem, v), 1.0f);
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

template <int CELL, typename X, typename S, int V>
__global__ void __launch_bounds__(256) temporal_cell_bwd_kernel(
    const X* __restrict__ x, const S* __restrict__ v0,
    const S* __restrict__ i0, const X* __restrict__ gz,
    const S* __restrict__ gvT, const S* __restrict__ giT,
    X* __restrict__ gx, S* __restrict__ gv0, S* __restrict__ gi0,
    S* __restrict__ ws_v, S* __restrict__ ws_i, int T, int64_t M, int start,
    float c_mem, float c_syn, float alpha) {
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (base >= M) return;

  // pass 1 (LIF): the state entering steps 1 .. T-1, to the workspace
  if (CELL == kLIF && T > 1) {
    float v[V], i[V];
    const Vec<S, V> vs = *reinterpret_cast<const Vec<S, V>*>(v0 + base);
    const Vec<S, V> is = *reinterpret_cast<const Vec<S, V>*>(i0 + base);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = to_f32(vs.a[k]);
      i[k] = to_f32(is.a[k]);
    }
    for (int t = 0; t + 1 < T; ++t) {
      const Vec<X, V> xc = *reinterpret_cast<const Vec<X, V>*>(x + t * M + base);
      Vec<S, V> vo, io;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float v_new = v[k], i_new = i[k];
        cell_math::cell_step<CELL>(to_f32(xc.a[k]), v_new, i_new, c_mem,
                                   c_syn);
        if (t >= start) {
          v[k] = cell_math::round_to<S>(v_new);
          i[k] = cell_math::round_to<S>(i_new);
        }
        vo.a[k] = from_f32<S>(v[k]);
        io.a[k] = from_f32<S>(i[k]);
      }
      *reinterpret_cast<Vec<S, V>*>(ws_v + t * M + base) = vo;
      *reinterpret_cast<Vec<S, V>*>(ws_i + t * M + base) = io;
    }
  }

  // pass 2: reverse time, the carried cotangents (Gv, Gi) in fp32
  float Gv[V], Gi[V];
  {
    const Vec<S, V> gvs = *reinterpret_cast<const Vec<S, V>*>(gvT + base);
    const Vec<S, V> gis = *reinterpret_cast<const Vec<S, V>*>(giT + base);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      Gv[k] = to_f32(gvs.a[k]);
      Gi[k] = to_f32(gis.a[k]);
    }
  }
  for (int t = T - 1; t >= 0; --t) {
    const bool active = t >= start;
    const Vec<X, V> gzc =
        *reinterpret_cast<const Vec<X, V>*>(gz + t * M + base);
    Vec<S, V> vs, is;
    if (CELL == kLIF) {
      const S* vp = t == 0 ? v0 : ws_v + (t - 1) * M;
      const S* ip = t == 0 ? i0 : ws_i + (t - 1) * M;
      vs = *reinterpret_cast<const Vec<S, V>*>(vp + base);
      is = *reinterpret_cast<const Vec<S, V>*>(ip + base);
    }
    Vec<X, V> gxo;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float gvr = cell_math::round_to<S>(Gv[k]);
      const float gir = cell_math::round_to<S>(Gi[k]);
      const float v = CELL == kLIF ? to_f32(vs.a[k]) : 0.0f;
      const float i = CELL == kLIF ? to_f32(is.a[k]) : 0.0f;
      float gv, gi;
      const float gxv = cell_step_vjp<CELL>(
          v, i, to_f32(gzc.a[k]), active ? gvr : 0.0f, active ? gir : 0.0f,
          c_mem, c_syn, alpha, gv, gi);
      gxo.a[k] = from_f32<X>(gxv);
      gv = cell_math::round_to<S>(gv);
      gi = cell_math::round_to<S>(gi);
      // a frozen step holds the carried state: its cotangent passes on,
      // plus the one from the step's output
      Gv[k] = active ? gv : __fadd_rn(gv, gvr);
      Gi[k] = active ? gi : __fadd_rn(gi, gir);
    }
    *reinterpret_cast<Vec<X, V>*>(gx + t * M + base) = gxo;
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
  void *gx, *gv0, *gi0, *ws_v, *ws_i;
};

template <int CELL, typename X, typename S>
int launch_bwd(const BwdArgs& a, int T, int64_t M, int start, float c_mem,
               float c_syn, float alpha, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(X);
  const size_t sv = V * sizeof(S);
  bool vec = M % V == 0 && aligned(a.gz, 16) && aligned(a.gx, 16) &&
             aligned(a.gvT, sv) && aligned(a.giT, sv) && aligned(a.gv0, sv) &&
             aligned(a.gi0, sv);
  if (CELL == kLIF) {
    vec = vec && aligned(a.x, 16) && aligned(a.v0, sv) && aligned(a.i0, sv) &&
          (T < 2 || (aligned(a.ws_v, sv) && aligned(a.ws_i, sv)));
  }
  const int threads = 256;
  const int64_t work = vec ? M / V : M;
  const int64_t blocks = (work + threads - 1) / threads;
  auto go = [&](auto kernel) {
    kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const X*>(a.x), static_cast<const S*>(a.v0),
        static_cast<const S*>(a.i0), static_cast<const X*>(a.gz),
        static_cast<const S*>(a.gvT), static_cast<const S*>(a.giT),
        static_cast<X*>(a.gx), static_cast<S*>(a.gv0), static_cast<S*>(a.gi0),
        static_cast<S*>(a.ws_v), static_cast<S*>(a.ws_i), T, M, start, c_mem,
        c_syn, alpha);
  };
  if (vec) {
    go(temporal_cell_bwd_kernel<CELL, X, S, V>);
  } else {
    go(temporal_cell_bwd_kernel<CELL, X, S, 1>);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int CELL, typename X>
int launch_bwd_state(int state_dtype, const BwdArgs& a, int T, int64_t M,
                     int start, float c_mem, float c_syn, float alpha,
                     cudaStream_t s) {
  switch (state_dtype) {
    case 0:
      return launch_bwd<CELL, X, float>(a, T, M, start, c_mem, c_syn, alpha,
                                        s);
    case 1:
      return launch_bwd<CELL, X, __nv_bfloat16>(a, T, M, start, c_mem, c_syn,
                                                alpha, s);
    case 2:
      return launch_bwd<CELL, X, E5M2>(a, T, M, start, c_mem, c_syn, alpha,
                                       s);
  }
  return -1;
}

template <int CELL>
int launch_bwd_x(int x_dtype, int state_dtype, const BwdArgs& a, int T,
                 int64_t M, int start, float c_mem, float c_syn, float alpha,
                 cudaStream_t s) {
  switch (x_dtype) {
    case 0:
      return launch_bwd_state<CELL, float>(state_dtype, a, T, M, start, c_mem,
                                           c_syn, alpha, s);
    case 1:
      return launch_bwd_state<CELL, __nv_bfloat16>(state_dtype, a, T, M,
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

// C entry point of the backward. ws_v, ws_i: workspaces of [T-1, M]
// state elements each (LIF with T > 1; unused otherwise). Type and cell
// codes and return values as above.
extern "C" int temporal_cell_seq_bwd_launch(
    const void* x, const void* v0, const void* i0, const void* gz,
    const void* gvT, const void* giT, void* gx, void* gv0, void* gi0,
    void* ws_v, void* ws_i, long long T, long long M, int start, int cell,
    int x_dtype, int state_dtype, float c_mem, float c_syn, float alpha,
    void* stream) {
  if (T < 0 || T > 0x7fffffff || M < 0) return -1;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(T);
  const BwdArgs a{x, v0, i0, gz, gvT, giT, gx, gv0, gi0, ws_v, ws_i};
  if (cell == kLIF) {
    return launch_bwd_x<kLIF>(x_dtype, state_dtype, a, t, M, start, c_mem,
                              c_syn, alpha, s);
  }
  if (cell == kLI) {
    return launch_bwd_x<kLI>(x_dtype, state_dtype, a, t, M, start, c_mem,
                             c_syn, alpha, s);
  }
  return -1;
}
