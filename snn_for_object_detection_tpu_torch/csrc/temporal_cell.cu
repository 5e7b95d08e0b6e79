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
