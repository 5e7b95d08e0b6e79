"""Neuron cells as plain PyTorch functions.

Counterpart of ``snn_for_object_detection_tpu/ops/neurons.py``: the same
norse cell semantics, ``step(x, state) -> (out, new_state)`` on tensors
of any shape, Euler integration with ``dt = 1e-3``. LIF, LI and PLIF are
the plain versions of the math that ``ops/cuda_kernels.temporal_cell_seq``
and ``plif_cell_seq`` run on the card; ALIF, SLI and Synapse run as they
are written here, on the CPU and on the card. The spike is
:func:`superspike`: a hard threshold forward and the SuperSpike
surrogate gradient backward.

Rounding. The JAX package computes ``v + dt*tau*(...)`` with a Python
float factor, so the factor is the double product rounded once to fp32
(``0.1f`` and ``0.2f``). XLA contracts each multiply-add of the update
into one fused multiply-add (one rounding); :func:`fma` reproduces
that exactly, so the cells agree bit for bit with the JAX package and
with the CUDA kernel, which uses ``__fmaf_rn`` at the same places.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch


def _fma_exact(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """The emulated fused multiply-add of :func:`fma` on the CPU."""
    p = a.double() * b
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    inexact = (err != 0) & torch.isfinite(err)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where(inexact & even, torch.nextafter(s, toward), s)
    return s.float()


class _Fma(torch.autograd.Function):
    """:func:`_fma_exact` with the gradient of ``a * b + c``: ``(g * b,
    g * a, g)``, a tensor ``b``'s summed over the dimensions it was
    broadcast along. Autograd cannot pass the fp64 bit arithmetic."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.b_is_tensor = isinstance(b, torch.Tensor)
        ctx.save_for_backward(a, b if ctx.b_is_tensor else None)
        ctx.b = None if ctx.b_is_tensor else b
        return _fma_exact(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if not ctx.b_is_tensor:
            return g * ctx.b, None, g
        gb = None
        if ctx.needs_input_grad[1]:
            gb = (g * a).sum_to_size(b.shape)
        return g * b, gb, g


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for fp32 tensors (``b`` a float or an fp32 tensor
    that broadcasts), rounded once to fp32.

    The product of two fp32 values is exact in fp64. The sum is then
    rounded to odd (an inexact fp64 sum moves to whichever neighbour
    has an odd last bit, using the exact TwoSum error), which keeps
    the later rounding to fp32 correct: the result is what a hardware
    fused multiply-add gives.

    On a CUDA tensor it is that hardware fused multiply-add: PyTorch's
    CUDA elementwise kernels are compiled with multiply-add contraction,
    so ``addcmul`` (and ``add`` with ``alpha``) round once there
    (``chip_smoke.py`` [3] holds it bit-equal to the emulation, which
    costs a dozen fp64 passes).
    """
    if a.is_cuda:
        if isinstance(b, torch.Tensor):
            return torch.addcmul(c, a, b)
        return torch.add(c, a, alpha=b)
    return _Fma.apply(a, b, c)


# e4m3 stores: every |x| above this (the tie halfway from the largest
# finite value 448 to the NaN encoding, which rounds to 448), every inf
# and NaN is stored as NaN with x's sign, as JAX's astype does
E4M3_LIMIT = 464.0


def to_state(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` stored in the neuron-state dtype ``dtype``: ``x.to(dtype)``,
    but for ``float8_e4m3fn`` JAX's ``astype``: round to nearest even (as
    the card's ``cvt.rn.satfinite.e4m3x2.f32``), and NaN, sign kept (bits
    0x7f / 0xff), for every ``|x| > E4M3_LIMIT``, inf and NaN. torch's
    own cast saturates those to 448. Its gradient is a cast's: the
    cotangent widened back to x's dtype."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    return _ToE4M3.apply(x)


def from_state(s: torch.Tensor) -> torch.Tensor:
    """A stored state widened to fp32, ``s.float()``, whose cotangent is
    stored back in the state's dtype by :func:`to_state` (JAX's
    ``astype`` pair); torch's own backward of ``float()`` would saturate
    an e4m3 cotangent."""
    if s.dtype != torch.float8_e4m3fn:
        return s.float()
    return _FromE4M3.apply(s)


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """:func:`to_state`'s e4m3 rounding, written out so that the CPU and
    the card give the same bits: ``|x|`` to a multiple of its e4m3
    quantum ``2**(e - 4)`` (``e`` of ``frexp``, at least ``2**-9``, the
    subnormal step), exact in fp32, then cast as an exact value."""
    dtype = torch.float8_e4m3fn
    xf = x.float()
    a = xf.abs()
    ok = a <= E4M3_LIMIT
    _, e = torch.frexp(torch.where(ok, a, 0.0))
    # the quantum, a power of two built from its exponent bits
    q = ((e.to(torch.int32) - 4).clamp(min=-9) + 127).bitwise_left_shift(
        23).view(torch.float32)
    r = torch.copysign(torch.where(ok, torch.round(a / q) * q, 0.0), xf)
    nan = torch.where(torch.signbit(xf), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(ok, r.to(dtype).view(torch.uint8), nan).view(dtype)


class _ToE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return _e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


class _FromE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s):
        return s.float()

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


class _SuperSpike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return (x > 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / (ctx.alpha * x.abs() + 1.0) ** 2, None


class _Reset(torch.autograd.Function):
    """``v_reset`` where the (detached) spike ``z`` fired, else ``v_dec``,
    with JAX's gradient of ``(1 - z) * v_dec + z * v_reset``: ``(1 - z) *
    g`` to ``v_dec``, which is NaN, not 0, where a spiking element's
    cotangent is NaN or inf (an overflowed fp8 cotangent)."""

    @staticmethod
    def forward(ctx, v_dec, z, v_reset):
        ctx.save_for_backward(z)
        return torch.where(z != 0, torch.full_like(v_dec, v_reset), v_dec)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        return (1.0 - z) * g, None, None


def reset(v_dec: torch.Tensor, z: torch.Tensor, v_reset: float
          ) -> torch.Tensor:
    """The LIF reset of :func:`lif_step` (the spike ``z`` carries no
    gradient through it)."""
    return _Reset.apply(v_dec, z.detach(), v_reset)


def superspike(x: torch.Tensor, alpha: float = 100.0) -> torch.Tensor:
    """Heaviside spike with the SuperSpike surrogate gradient.

    Forward: ``(x > 0)`` (strict, as norse's ``torch.gt``), in x's
    dtype. Backward: ``g / (alpha * |x| + 1) ** 2``.
    """
    return _SuperSpike.apply(x, alpha)


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """Static LIF parameters (norse defaults)."""

    tau_syn_inv: float = 1.0 / 5e-3
    tau_mem_inv: float = 1.0 / 1e-2
    v_leak: float = 0.0
    v_th: float = 1.0
    v_reset: float = 0.0
    alpha: float = 100.0
    dt: float = 1e-3


class LIFState(NamedTuple):
    v: torch.Tensor
    i: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LIParams:
    tau_syn_inv: float = 1.0 / 5e-3
    tau_mem_inv: float = 1.0 / 1e-2
    v_leak: float = 0.0
    dt: float = 1e-3


class LIState(NamedTuple):
    v: torch.Tensor
    i: torch.Tensor


def euler_factors(p) -> Tuple[float, float]:
    """``(dt * tau_mem_inv, dt * tau_syn_inv)``: the double products
    rounded once to fp32, as JAX rounds a weak-typed Python scalar."""
    return tuple(
        torch.tensor(f, dtype=torch.float32).item()
        for f in (p.dt * p.tau_mem_inv, p.dt * p.tau_syn_inv)
    )


def lif_init(shape, dtype=torch.float32, device="cuda",
             p: LIFParams = LIFParams()) -> LIFState:
    return LIFState(
        v=torch.full(shape, p.v_leak, dtype=dtype, device=device),
        i=torch.zeros(shape, dtype=dtype, device=device),
    )


def li_init(shape, dtype=torch.float32, device="cuda",
            p: LIParams = LIParams()) -> LIState:
    return LIState(
        v=torch.full(shape, p.v_leak, dtype=dtype, device=device),
        i=torch.zeros(shape, dtype=dtype, device=device),
    )


def lif_step(
    x: torch.Tensor, state: LIFState, p: LIFParams = LIFParams()
) -> Tuple[torch.Tensor, LIFState]:
    """One Euler step of a feed-forward LIF neuron, fp32.

    norse ``lif_feed_forward_step`` order: decay (v, i), spike from the
    decayed v (:func:`superspike` of ``v_dec - v_th``), reset, then
    inject the input into the current. The reset gate carries no
    gradient (JAX's ``stop_gradient(z)``): the reset passes ``(1 - z)
    * g`` to ``v_dec`` (:func:`reset`).
    """
    v, i = state
    c_mem, c_syn = euler_factors(p)
    v_dec = fma((p.v_leak - v) + i, c_mem, v)
    i_dec = fma(i, -c_syn, i)
    z = superspike(v_dec - p.v_th, p.alpha)
    v_new = reset(v_dec, z, p.v_reset)
    return z, LIFState(v_new, i_dec + x)


def li_step(
    x: torch.Tensor, state: LIState, p: LIParams = LIParams()
) -> Tuple[torch.Tensor, LIState]:
    """One Euler step of a leaky integrator, fp32; output is the
    membrane voltage. norse ``li_feed_forward_step``: the input current
    jump comes *before* the voltage update (unlike LIF)."""
    v, i = state
    c_mem, c_syn = euler_factors(p)
    i_jump = i + x
    v_new = fma((p.v_leak - v) + i_jump, c_mem, v)
    i_dec = fma(i_jump, -c_syn, i_jump)
    return v_new, LIState(v_new, i_dec)


def _f32(value: float) -> float:
    """A Python float rounded to fp32, as JAX rounds a weak-typed
    scalar."""
    return torch.tensor(value, dtype=torch.float32).item()


# ---- PLIF: LIF with learnable per-channel time constants ----


class PLIFParams(NamedTuple):
    """Trainable per-channel inverse time constants, positive through
    softplus at apply time."""

    raw_tau_syn: torch.Tensor  # softplus(raw) = tau_syn_inv
    raw_tau_mem: torch.Tensor


def _inv_softplus(y: float) -> float:
    return math.log(math.expm1(y))


def plif_params_init(channels: int, tau_syn_inv: float = 1.0 / 5e-3,
                     tau_mem_inv: float = 1.0 / 1e-2,
                     device="cpu") -> PLIFParams:
    """Raw parameters whose softplus is the LIF defaults."""
    return PLIFParams(
        raw_tau_syn=torch.full((channels,), _inv_softplus(tau_syn_inv),
                               dtype=torch.float32, device=device),
        raw_tau_mem=torch.full((channels,), _inv_softplus(tau_mem_inv),
                               dtype=torch.float32, device=device),
    )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as JAX's ``jax.nn.softplus``
    (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def plif_factors(learn: PLIFParams, p: LIFParams = LIFParams()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(c_mem, c_syn)``: the fp32 ``[C]`` Euler factors ``dt *
    softplus(raw)``, computed before they multiply the state (JAX's
    ``p.dt * tau_mem_inv * (...)`` evaluates left to right)."""
    return (p.dt * softplus(learn.raw_tau_mem),
            p.dt * softplus(learn.raw_tau_syn))


def plif_step_factors(
    x: torch.Tensor, state: LIFState, c_mem: torch.Tensor,
    c_syn: torch.Tensor, p: LIFParams = LIFParams(),
) -> Tuple[torch.Tensor, LIFState]:
    """:func:`lif_step` with the per-channel factors ``c_mem``, ``c_syn``
    (fp32 ``[C]``, broadcast along the trailing axis) in place of LIF's
    constants: the same ops in the same order."""
    v, i = state
    v_dec = fma((p.v_leak - v) + i, c_mem, v)
    i_dec = fma(i, -c_syn, i)
    z = superspike(v_dec - p.v_th, p.alpha)
    v_new = reset(v_dec, z, p.v_reset)
    return z, LIFState(v_new, i_dec + x)


def plif_step(
    x: torch.Tensor, state: LIFState, learn: PLIFParams,
    p: LIFParams = LIFParams(),
) -> Tuple[torch.Tensor, LIFState]:
    """LIF dynamics with learnable per-channel decay rates (channels on
    the trailing axis, NHWC), fp32."""
    return plif_step_factors(x, state, *plif_factors(learn, p), p)


# ---- ALIF: adaptive-threshold LIF ----


@dataclasses.dataclass(frozen=True)
class ALIFParams:
    tau_syn_inv: float = 1.0 / 5e-3
    tau_mem_inv: float = 1.0 / 1e-2
    tau_adapt_inv: float = 1.0 / 1e-1
    beta: float = 0.2  # threshold jump per spike
    v_leak: float = 0.0
    v_th: float = 1.0
    v_reset: float = 0.0
    alpha: float = 100.0
    dt: float = 1e-3


class ALIFState(NamedTuple):
    v: torch.Tensor
    i: torch.Tensor
    b: torch.Tensor  # adaptive threshold offset


def alif_init(shape, dtype=torch.float32, device="cuda",
              p: ALIFParams = ALIFParams()) -> ALIFState:
    return ALIFState(
        v=torch.full(shape, p.v_leak, dtype=dtype, device=device),
        i=torch.zeros(shape, dtype=dtype, device=device),
        b=torch.zeros(shape, dtype=dtype, device=device),
    )


def alif_step(
    x: torch.Tensor, state: ALIFState, p: ALIFParams = ALIFParams()
) -> Tuple[torch.Tensor, ALIFState]:
    """LIF whose threshold ``v_th + b`` rises by ``beta`` a spike and
    decays at ``tau_adapt_inv``, fp32. The spike's gradient reaches
    ``v_dec`` and ``b_dec``; the reset and the jump carry none."""
    v, i, b = state
    c_mem, c_syn = euler_factors(p)
    c_adapt = _f32(p.dt * p.tau_adapt_inv)
    v_dec = fma((p.v_leak - v) + i, c_mem, v)
    i_dec = fma(i, -c_syn, i)
    b_dec = fma(b, -c_adapt, b)
    z = superspike(v_dec - (p.v_th + b_dec), p.alpha)
    zs = z.detach()
    v_new = torch.where(zs != 0, torch.full_like(v_dec, p.v_reset), v_dec)
    b_new = b_dec + _f32(p.beta) * zs
    return z, ALIFState(v_new, i_dec + x, b_new)


# ---- SLI: saturable leaky integrator ----


@dataclasses.dataclass(frozen=True)
class SLIParams:
    tau_syn_inv: float = 1.0 / 5e-3
    tau_mem_inv: float = 1.0 / 1e-2
    v_leak: float = 0.0
    v_st: float = 1.0
    dt: float = 1e-3


class SLIState(NamedTuple):
    v: torch.Tensor
    i: torch.Tensor


def sli_init(shape, dtype=torch.float32, device="cuda",
             p: SLIParams = SLIParams()) -> SLIState:
    return SLIState(
        v=torch.full(shape, p.v_leak, dtype=dtype, device=device),
        i=torch.zeros(shape, dtype=dtype, device=device),
    )


def sli_step(
    x: torch.Tensor, state: SLIState, p: SLIParams = SLIParams()
) -> Tuple[torch.Tensor, SLIState]:
    """LI whose input is gated by ``sigmoid(v_st - |v|)``, so the
    membrane saturates at about ``v_st``; output is the membrane, fp32."""
    v, i = state
    c_mem, c_syn = euler_factors(p)
    i_jump = fma(x, torch.sigmoid(p.v_st - v.abs()), i)
    v_new = fma((p.v_leak - v) + i_jump, c_mem, v)
    i_dec = fma(i_jump, -c_syn, i_jump)
    return v_new, SLIState(v_new, i_dec)


# ---- Synapse: mediator-concentration transmission ----


@dataclasses.dataclass(frozen=True)
class SynapseParams:
    tau_med_secretion: float = 1.0 / 1e-3
    tau_med_dissociation: float = 1.0 / 5e-3
    sigma_inhibition: float = 0.0
    dt: float = 1e-3

    def __post_init__(self):
        if self.sigma_inhibition != 0 and self.sigma_inhibition < 0.5:
            raise ValueError(
                "Valid values for sigma_inhibition are 0 or >= 0.5, got "
                f"{self.sigma_inhibition}"
            )


class SynapseState(NamedTuple):
    p: torch.Tensor


def synapse_init(shape, dtype=torch.float32, device="cuda",
                 p: SynapseParams = SynapseParams()) -> SynapseState:
    return SynapseState(p=torch.zeros(shape, dtype=dtype, device=device))


def synapse_step(
    x: torch.Tensor, state: SynapseState, p: SynapseParams = SynapseParams()
) -> Tuple[torch.Tensor, SynapseState]:
    """The mediator concentration relaxes toward the input, at the
    secretion rate where the input is positive and the dissociation rate
    elsewhere; with ``sigma_inhibition >= 0.5`` a parabolic inhibition
    ``4 s (p - s p^2)``. The output is clipped at 0 (``maximum``: a tie
    passes half the gradient, as JAX's), fp32."""
    tau = torch.where(x > 0, _f32(p.tau_med_secretion),
                      _f32(p.tau_med_dissociation))
    p_new = fma((x - state.p) * tau, _f32(p.dt), state.p)
    g = p_new
    if p.sigma_inhibition != 0:
        s = _f32(p.sigma_inhibition)
        g = _f32(4.0 * p.sigma_inhibition) * fma(p_new * p_new, -s, p_new)
    return torch.maximum(g, torch.zeros_like(g)), SynapseState(p_new)
