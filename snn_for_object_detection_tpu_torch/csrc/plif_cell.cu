// PLIF over T steps and its backward, for Hopper (sm_90a): the PLIF form
// of the cell kernels in cell_kernels.cuh (kPLIF), which temporal_cell.cu
// runs for LIF and LI. JAX runs PLIF as a lax.scan of neurons.plif_step
// (models/compile.py's PLIF leaf), no Pallas kernel; the port keeps the
// layer in one launch, as temporal_cell_seq keeps LIF.
//
// PLIF (plif_cell_seq_launch) is LIF with per-channel Euler factors:
// c_mem[C] and c_syn[C] (fp32, dt * softplus of the learnable raw time
// constants, ops/cuda_kernels.py's plif_cell_seq) in place of LIF's two
// constants. A thread reads the factors of its V elements' channels
// (flat index mod C, channels last) once, before the time loop; every
// other part of the kernel is LIF's. Its backward also returns, for
// every element, its sums over t of the cotangents of c_mem and c_syn
// (fp32 [M] each; the wrapper sums them over the rows to [C]).
//
// Backward: the chunked recompute of temporal_cell.cu's LIF backward,
// each step's entering (v, i) kept in registers in place of s (twice
// LIF's values, so one shorter chunk a width is built: plif_chunk), the
// step's products g_vdec * d and gin * i added to the element's sums,
// which the wrapper sums over the rows. At T = 1 the single reverse pass.
// The ops and their order are plif_step_factors' under autograd, so gx,
// gv0 and gi0 are bit-equal to the plain version.

#include "cell_kernels.cuh"

// C entry point of PLIF's forward: as LIF's, with the factors cm[C] and
// cs[C] (fp32) of the trailing axis of C channels (M a multiple of C).
extern "C" int plif_cell_seq_launch(const void* x, const void* v0,
                                    const void* i0, void* z, void* vT,
                                    void* iT, const float* cm,
                                    const float* cs, long long T, long long M,
                                    int C, int start, int x_dtype,
                                    int state_dtype, void* stream) {
  if (T < 0 || T > 0x7fffffff || M < 0 || C <= 0 || M % C != 0) return -1;
  if (M == 0) return 0;
  const Factors f{cm, cs, C, 0.0f, 0.0f};
  return launch_x<kPLIF>(x_dtype, state_dtype, x, v0, i0, z, vT, iT,
                         static_cast<int>(T), M, start, f,
                         static_cast<cudaStream_t>(stream));
}

// C entry point of PLIF's backward: LIF's, with the factors cm[C], cs[C]
// and the factor sums gcm[M], gcs[M] (fp32: each element's sum over t of
// the cotangents of its c_mem and of -c_syn). The chunked kernel takes
// only the chunk its width is built for (plif_chunk).
extern "C" int plif_cell_seq_bwd_launch(
    const void* x, const void* v0, const void* i0, const void* gz,
    const void* gvT, const void* giT, void* gx, void* gv0, void* gi0,
    void* ckpt, const float* cm, const float* cs, float* gcm, float* gcs,
    long long T, long long M, int C, int start, int x_dtype,
    int state_dtype, float alpha, int chunk, int threads, int vec, int smem,
    void* stream) {
  if (T < 0 || T > 0x7fffffff || M < 0 || C <= 0 || M % C != 0) return -1;
  if (M == 0) return 0;
  const BwdArgs a{x, v0, i0, gz, gvT, giT, gx, gv0, gi0, ckpt, gcm, gcs};
  const BwdPlan p{chunk, threads, vec, smem};
  const Factors f{cm, cs, C, 0.0f, 0.0f};
  return launch_bwd_x<kPLIF>(x_dtype, state_dtype, a, p, static_cast<int>(T),
                             M, start, f, alpha,
                             static_cast<cudaStream_t>(stream));
}

// Registers a thread of PLIF's chunked backward kernel, for the x type,
// the state type and the vector path (what ops/cuda_kernels.py's plan
// model reads; -1 for an unsupported argument).
extern "C" int plif_cell_bwd_regs(int x_dtype, int state_dtype, int vec) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaErrorInvalidValue;
  auto get = [&](auto kernel) { e = cudaFuncGetAttributes(&attr, kernel); };
#define REGS(X, S)                                                          \
  if (vec) {                                                                \
    constexpr int V = 16 / sizeof(X);                                       \
    get(temporal_cell_bwd_chunked_kernel<kPLIF, plif_chunk(V), X, S, V>);   \
  } else {                                                                  \
    get(temporal_cell_bwd_chunked_kernel<kPLIF, plif_chunk(1), X, S, 1>);   \
  }
  if (x_dtype == 0 && state_dtype == 0) { REGS(float, float) }
  else if (x_dtype == 0 && state_dtype == 1) { REGS(float, __nv_bfloat16) }
  else if (x_dtype == 0 && state_dtype == 2) { REGS(float, E5M2) }
  else if (x_dtype == 0 && state_dtype == 3) { REGS(float, E4M3) }
  else if (x_dtype == 1 && state_dtype == 0) { REGS(__nv_bfloat16, float) }
  else if (x_dtype == 1 && state_dtype == 1) {
    REGS(__nv_bfloat16, __nv_bfloat16)
  } else if (x_dtype == 1 && state_dtype == 2) {
    REGS(__nv_bfloat16, E5M2)
  } else if (x_dtype == 1 && state_dtype == 3) {
    REGS(__nv_bfloat16, E4M3)
  }
#undef REGS
  return e == cudaSuccess ? attr.numRegs : -1;
}
