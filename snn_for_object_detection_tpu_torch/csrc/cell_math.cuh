// Device code shared by the port's kernels: storage conversions and the
// fp32 LIF / LI update of one element for one time step.
//
// Rounding matches the plain PyTorch versions (ops/neurons.py), which
// match the JAX package bit for bit: the two multiply-adds of each
// update are fused (__fmaf_rn) because XLA contracts them; every other
// op rounds on its own (the sources are built with --fmad=false). bf16
// and e5m2 stores round to nearest even, and e5m2 overflow gives inf as
// in JAX and PyTorch. e4m3 stores give NaN, sign kept, for every |a| >
// 464 and every inf and NaN, as JAX's astype does (ops/neurons.py's
// to_state; PyTorch's cast saturates to 448).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cell_math {

struct E5M2 {
  unsigned char bits;
};
struct E4M3 {
  unsigned char bits;
};

__device__ __forceinline__ float to_f32(float a) { return a; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 a) {
  return __bfloat162float(a);
}
__device__ __forceinline__ float to_f32(E5M2 a) {
  // e5m2 is the top byte of an fp16: widening is exact
  __half_raw h;
  h.x = static_cast<unsigned short>(a.bits) << 8;
  return __half2float(__half(h));
}
__device__ __forceinline__ float to_f32(E4M3 a) {
  // every e4m3 value is an fp16 value: widening is exact. The hardware
  // conversion gives a NaN without its sign; a NaN stored again keeps it
  // (as PyTorch's widening and ops/neurons.py's to_state do)
  if ((a.bits & 0x7F) == 0x7F) {
    return __uint_as_float((static_cast<unsigned>(a.bits & 0x80) << 24) |
                           0x7FC00000u);
  }
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(a.bits, __NV_E4M3)));
}

template <typename T>
__device__ __forceinline__ T from_f32(float a);
template <>
__device__ __forceinline__ float from_f32<float>(float a) { return a; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float a) {
  return __float2bfloat16_rn(a);
}
template <>
__device__ __forceinline__ E5M2 from_f32<E5M2>(float a) {
  // The hardware conversion (cvt.rn.satfinite) rounds to nearest even
  // but saturates; the __NV_NOSAT form is a slow software path. Without
  // saturation every |a| >= 61440 (halfway from the largest finite
  // value 57344 to 2^16, a tie that rounds up to the even inf) is inf.
  E5M2 r;
  r.bits = __nv_cvt_float_to_fp8(a, __NV_SATFINITE, __NV_E5M2);
  if (fabsf(a) >= 61440.0f) r.bits = (r.bits & 0x80) | 0x7C;
  return r;
}
template <>
__device__ __forceinline__ E4M3 from_f32<E4M3>(float a) {
  // The same hardware conversion, saturating to 448. JAX gives NaN with
  // a's sign (0x7F / 0xFF) past 464 (the tie halfway to the NaN
  // encoding, which rounds to 448), and for inf and NaN.
  E4M3 r;
  r.bits = __nv_cvt_float_to_fp8(a, __NV_SATFINITE, __NV_E4M3);
  if (!(fabsf(a) <= 464.0f)) {
    r.bits = static_cast<unsigned char>((__float_as_uint(a) >> 24) & 0x80) |
             0x7F;
  }
  return r;
}

// a rounded to the storage type T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float a) {
  return to_f32(from_f32<T>(a));
}

enum Cell { kLIF = 0, kLI = 1, kPLIF = 2 };

// One Euler step of the cell on fp32 (v, i) with input x; updates (v, i)
// in place (unrounded) and returns the output: the spike (0 or 1) for
// LIF, the membrane v for LI. c_mem = dt * tau_mem_inv and c_syn =
// dt * tau_syn_inv are the fp32 Euler factors (ops/neurons.py): LIF's
// constants, or PLIF's per-channel dt * softplus(raw) of the element's
// channel (PLIF is LIF with those factors).
//
// LIF (norse lif_feed_forward_step): decay -> spike -> reset -> inject.
// LI (li_feed_forward_step): the current jump comes before the voltage
// update. PLAIN_RESET selects the reset of the pointwise TPU kernel,
// v' = (1 - z) * v_dec, which differs from the select only where v_dec
// is inf or NaN.
template <int CELL, bool PLAIN_RESET = false>
__device__ __forceinline__ float cell_step(float x, float& v, float& i,
                                           float c_mem, float c_syn) {
  if (CELL != kLI) {
    const float d = __fadd_rn(__fsub_rn(0.0f, v), i);
    const float v_dec = __fmaf_rn(d, c_mem, v);
    const float i_dec = __fmaf_rn(i, -c_syn, i);
    const bool spike = __fsub_rn(v_dec, 1.0f) > 0.0f;
    const float z = spike ? 1.0f : 0.0f;
    if (PLAIN_RESET) {
      v = __fmul_rn(__fsub_rn(1.0f, z), v_dec);
    } else {
      v = spike ? 0.0f : v_dec;
    }
    i = __fadd_rn(i_dec, x);
    return z;
  } else {
    const float i_jump = __fadd_rn(i, x);
    const float d = __fadd_rn(__fsub_rn(0.0f, v), i_jump);
    v = __fmaf_rn(d, c_mem, v);
    i = __fmaf_rn(i_jump, -c_syn, i_jump);
    return v;  // LI emits fp32 v before the state is quantized
  }
}

}  // namespace cell_math
