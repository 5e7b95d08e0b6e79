// Whole-layer LIF / LI cell over T time steps, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `temporal_cell_seq`
// (snn_for_object_detection_tpu/ops/pallas_kernels.py: `_temporal_kernel`
// under `_temporal_pallas_core`'s pallas_call). Same function:
//   in:  x[T, M] (fp32 or bf16), v0[M], i0[M] (fp32, bf16,
//        fp8 e5m2 or e4m3)
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
// spiking_conv.cu; the kernels and their launch templates are in
// cell_kernels.cuh, shared with plif_cell.cu.
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

#include "cell_kernels.cuh"

// C entry point (loaded with ctypes). Type codes: 0 fp32, 1 bf16,
// 2 fp8 e5m2, 3 fp8 e4m3 (state only); cell 0 = LIF, 1 = LI. Returns 0 on success,
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
  const Factors f{nullptr, nullptr, 1, c_mem, c_syn};
  if (cell == kLIF) {
    return launch_x<kLIF>(x_dtype, state_dtype, x, v0, i0, z, vT, iT, t, M,
                          start, f, s);
  }
  if (cell == kLI) {
    return launch_x<kLI>(x_dtype, state_dtype, x, v0, i0, z, vT, iT, t, M,
                         start, f, s);
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
  const BwdArgs a{x, v0, i0, gz, gvT, giT, gx, gv0, gi0, ckpt, nullptr,
                  nullptr};
  const BwdPlan p{chunk, threads, vec, smem};
  const Factors f{nullptr, nullptr, 1, c_mem, c_syn};
  if (cell == kLIF) {
    return launch_bwd_x<kLIF>(x_dtype, state_dtype, a, p, t, M, start, f,
                              alpha, s);
  }
  if (cell == kLI) {
    return launch_bwd_x<kLI>(x_dtype, state_dtype, a, p, t, M, start, f,
                             alpha, s);
  }
  return -1;
}
