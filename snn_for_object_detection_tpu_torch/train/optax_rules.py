"""optax factories written out in torch, from optax 0.2.6's own updates.

The trainer's optimizer chain (``loop.Optimizer``) runs ``adamax``
through ``torch.optim.Adamax``, whose update is optax's for every option
``adamax`` takes. Every other factory of ``optax._src.alias`` is a
:class:`Rule`: the factory's own ``chain`` of transforms, each written
from optax's update (``scale_by_adam``, ``add_decayed_weights``,
``scale_by_trust_ratio``, ``trace``, ...), so that a factory's options
mean what they mean in optax:

- ``adam``, ``adamw``, ``nadam``, ``nadamw``, ``amsgrad``, ``adamaxw``,
  ``adan``, ``radam``, ``adabelief``, ``yogi``, ``lamb``, ``novograd``,
  ``lion``, ``rmsprop``, ``adagrad``, ``adadelta``, ``adafactor``,
  ``sm3``, ``fromage``, ``lars``, ``sgd``, ``noisy_sgd``, ``sign_sgd``,
  ``rprop``, ``optimistic_gradient_descent``, ``optimistic_adam``,
  ``optimistic_adam_v2``;
- ``lbfgs`` and ``polyak_sgd``, whose update needs the loss value
  (``value``, ``value_fn``) that the trainer's update does not pass: the
  first step raises ``TypeError``, as under JAX's trainer.

Each update is the chain's, ended by ``scale_by_learning_rate`` (the
update scaled by ``-lr``) as the factory ends it, and added to ``p``
(``apply_updates``). The scalar factors (bias corrections, RAdam's
rectification) are computed in float32 as optax computes them: ``decay
** count`` by binary exponentiation, as XLA does, so that RAdam's ``ro``
(a difference of two numbers near ``2 / (1 - b2)``) rounds alike.

The options that take a dtype (``mu_dtype``, ``accumulator_dtype``,
``dtype_momentum``) take its name (``"bfloat16"``) or a torch dtype; the
moment is stored in it between steps, as optax casts it. The masks
(``mask``, ``weight_decay_mask``, ``trust_ratio_mask``) take a bool for
every parameter, a dict of bools by parameter name, or a callable over
``{name: tensor}`` that returns one of these (optax's tree is JAX's, the
port's is its module's names). A conv kernel is OIHW here and HWIO in
JAX: ``adafactor`` factors the second moment over the two dims JAX's
layout would pick (``_factored_dims``, ties by position), mapped to the
port's. ``noisy_sgd`` draws its noise from a ``torch.Generator`` seeded
by ``key`` (or ``seed``), not from JAX's key: the same law, not the same
draws. A keyword optax does not take raises ``TypeError``, as optax does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

_ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
         "mu_dtype": None, "nesterov": False}
# factory -> optax 0.2.6's keyword defaults
FACTORIES: Dict[str, Dict[str, Any]] = {
    "adam": _ADAM,
    "adamw": {**_ADAM, "weight_decay": 1e-4, "mask": None},
    "nadam": {**_ADAM, "nesterov": True},
    "nadamw": {**_ADAM, "weight_decay": 1e-4, "mask": None,
               "nesterov": True},
    "amsgrad": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
                "mu_dtype": None},
    "adamaxw": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 1e-4,
                "mask": None},
    "adan": {"b1": 0.98, "b2": 0.92, "b3": 0.99, "eps": 1e-8,
             "eps_root": 1e-8, "weight_decay": 0.0, "mask": None},
    "radam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
              "threshold": 5.0, "nesterov": False},
    "adabelief": {"b1": 0.9, "b2": 0.999, "eps": 1e-16, "eps_root": 1e-16,
                  "nesterov": False},
    "yogi": {"b1": 0.9, "b2": 0.999, "eps": 1e-3},
    "lamb": {"b1": 0.9, "b2": 0.999, "eps": 1e-6, "eps_root": 0.0,
             "weight_decay": 0.0, "mask": None},
    "novograd": {"b1": 0.9, "b2": 0.25, "eps": 1e-6, "eps_root": 0.0,
                 "weight_decay": 0.0},
    "lion": {"b1": 0.9, "b2": 0.99, "mu_dtype": None, "weight_decay": 1e-3,
             "mask": None},
    "rmsprop": {"decay": 0.9, "eps": 1e-8, "initial_scale": 0.0,
                "eps_in_sqrt": True, "centered": False, "momentum": None,
                "nesterov": False, "bias_correction": False},
    "adagrad": {"initial_accumulator_value": 0.1, "eps": 1e-7},
    "adadelta": {"rho": 0.9, "eps": 1e-6, "weight_decay": 0.0,
                 "weight_decay_mask": None},
    "adafactor": {"min_dim_size_to_factor": 128, "decay_rate": 0.8,
                  "decay_offset": 0, "multiply_by_parameter_scale": True,
                  "clipping_threshold": 1.0, "momentum": None,
                  "dtype_momentum": "float32", "weight_decay_rate": None,
                  "eps": 1e-30, "factored": True, "weight_decay_mask": None},
    "sm3": {"momentum": 0.9},
    "fromage": {"min_norm": 1e-6},
    "lars": {"weight_decay": 0.0, "weight_decay_mask": True,
             "trust_coefficient": 0.001, "eps": 0.0,
             "trust_ratio_mask": True, "momentum": 0.9, "nesterov": False},
    "sgd": {"momentum": None, "nesterov": False, "accumulator_dtype": None},
    "noisy_sgd": {"eta": 0.01, "gamma": 0.55, "key": None, "seed": None},
    "sign_sgd": {},
    "rprop": {"eta_minus": 0.5, "eta_plus": 1.2, "min_step_size": 1e-6,
              "max_step_size": 50.0},
    "optimistic_gradient_descent": {"alpha": 1.0, "beta": 1.0},
    "optimistic_adam": {"optimism": None, "b1": 0.9, "b2": 0.999,
                        "eps": 1e-8, "eps_root": 0.0, "mu_dtype": None,
                        "nesterov": True},
    "optimistic_adam_v2": {"alpha": 1.0, "beta": 1.0, "b1": 0.9,
                           "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
                           "mu_dtype": None, "nesterov": True},
    "lbfgs": {"memory_size": 10, "scale_init_precond": True,
              "linesearch": "zoom"},
    "polyak_sgd": {"scaling": 1.0, "f_min": 0.0, "eps": 0.0,
                   "variant": "sps"},
}
# the factories whose update needs the loss value, and what it misses
NEEDS_VALUE = {
    "lbfgs": "scale_by_zoom_linesearch's update needs the keyword "
             "arguments 'value', 'grad' and 'value_fn'",
    "polyak_sgd": "scale_by_polyak's update needs the keyword argument "
                  "'value'",
}
# the factories whose learning rate optax takes as a float only (fixed at
# construction: rprop's initial step size, sm3's and optimistic_adam's
# scale), not a schedule
FLOAT_LR = ("rprop", "sm3", "optimistic_adam")
# a conv kernel's JAX (HWIO) dims, in the port's OIHW tensor
_HWIO_IN_OIHW = (2, 3, 1, 0)


def f32_pow(base: float, count: int) -> np.float32:
    """``base ** count`` in float32 by binary exponentiation (XLA's
    power of a float by an integer, bit for bit)."""
    acc, b = np.float32(1.0), np.float32(base)
    while count:
        if count & 1:
            acc = np.float32(acc * b)
        b = np.float32(b * b)
        count >>= 1
    return acc


def bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count``, in float32."""
    return float(np.float32(1.0) - f32_pow(decay, count))


def radam_ro(b2: float, count: int) -> np.float32:
    """RAdam's ``ro`` at ``count`` (float32, optax's order)."""
    f = np.float32
    ro_inf = f(2.0 / (1.0 - b2) - 1.0)
    b2t = f32_pow(b2, count)
    return f(ro_inf - f(f(f(2 * count) * b2t) / f(f(1.0) - b2t)))


def radam_r(b2: float, ro: np.float32) -> np.float32:
    f = np.float32
    ro_inf = f(2.0 / (1.0 - b2) - 1.0)
    return f(np.sqrt(f(f(f(f(ro - f(4.0)) * f(ro - f(2.0))) * ro_inf)
                       / f(f(f(ro_inf - f(4.0)) * f(ro_inf - f(2.0))) * ro))))


def as_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype from a dtype, its name (``"bfloat16"``,
    ``"jnp.bfloat16"``) or ``None``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).split(".")[-1].strip("'>")
    value = getattr(torch, name, None)
    if not isinstance(value, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return value


def jax_shape(shape: Sequence[int]) -> tuple:
    """A parameter's shape in JAX's layout: a conv kernel (4-D, OIHW
    here) as HWIO; any other as it is."""
    if len(shape) != 4:
        return tuple(shape)
    return tuple(shape[d] for d in _HWIO_IN_OIHW)


def factored_dims(shape: Sequence[int], factored: bool,
                  min_dim_size_to_factor: int) -> Optional[tuple]:
    """adafactor's ``(d1, d0)``, the second largest and the largest dim of
    the parameter, as optax picks them on JAX's layout (``np.argsort``,
    ties by position), given as the port's dims."""
    if not factored or len(shape) < 2:
        return None
    js = jax_shape(shape)
    order = np.argsort(js)
    if js[order[-2]] < min_dim_size_to_factor:
        return None
    if len(shape) == 4:
        return _HWIO_IN_OIHW[int(order[-2])], _HWIO_IN_OIHW[int(order[-1])]
    return int(order[-2]), int(order[-1])


def _norm(x: torch.Tensor, min_norm: float) -> torch.Tensor:
    """optax's ``safe_norm``: the L2 norm, ``min_norm`` where it is at
    most that."""
    n = torch.linalg.vector_norm(x)
    return torch.where(n <= min_norm, torch.full_like(n, min_norm), n)


def _rms(x: torch.Tensor, min_rms: float) -> torch.Tensor:
    """optax's ``safe_root_mean_squares``."""
    r = torch.sqrt(torch.mean(x * x))
    return torch.where(r <= min_rms, torch.full_like(r, min_rms), r)


def _decayed(decay: float, moment: torch.Tensor,
             like: torch.Tensor) -> torch.Tensor:
    """``decay * moment`` as jitted optax computes it for a moment stored
    in a narrower dtype: the (weakly typed) decay rounded to the moment's
    dtype, the product in the update's dtype (XLA widens the bf16
    multiply and drops its rounding); a float32 moment as it is."""
    narrow = float(torch.tensor(decay, dtype=moment.dtype))
    return narrow * moment.to(like.dtype)


# ---- the transforms: each optax's init and update on a list of leaves ----


class _Transform:
    """One optax ``GradientTransformation``: :meth:`init` gives its state
    (key -> a value a parameter), :meth:`update` the updates of one step
    (``count``: this update's 1-based count, optax's ``count_inc``;
    ``lr``: the learning rate of this update)."""

    def init(self, params: List[torch.Tensor]) -> Dict[str, list]:
        return {}

    def update(self, us, st, params, count, lr, ctx):
        raise NotImplementedError


class _Adam(_Transform):
    """``scale_by_adam``: the moments, ``nesterov`` and ``mu_dtype``."""

    def __init__(self, b1, b2, eps, eps_root, mu_dtype=None, nesterov=False):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.mu_dtype, self.nesterov = as_dtype(mu_dtype), nesterov

    def init(self, params):
        return {"mu": [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(self, us, st, params, count, lr, ctx):
        b1, b2 = self.b1, self.b2
        out = []
        for i, g in enumerate(us):
            mu = (1 - b1) * g + _decayed(b1, st["mu"][i], g)
            nu = (1 - b2) * (g * g) + b2 * st["nu"][i]
            if self.nesterov:
                mu_hat = (b1 * (mu / bias_correction(b1, count + 1))
                          + (1 - b1) * (g / bias_correction(b1, count)))
            else:
                mu_hat = mu / bias_correction(b1, count)
            nu_hat = nu / bias_correction(b2, count)
            out.append(mu_hat / (torch.sqrt(nu_hat + self.eps_root)
                                 + self.eps))
            st["mu"][i] = mu.to(st["mu"][i].dtype)
            st["nu"][i] = nu
        return out


class _Radam(_Adam):
    """``scale_by_radam``: Adam's moments, the update rectified by ``r``
    once ``ro`` passes ``threshold``."""

    def __init__(self, b1, b2, eps, eps_root, threshold, nesterov):
        super().__init__(b1, b2, eps, eps_root, None, nesterov)
        self.threshold = threshold

    def update(self, us, st, params, count, lr, ctx):
        b1, b2 = self.b1, self.b2
        ro = radam_ro(b2, count)
        out = []
        for i, g in enumerate(us):
            mu = (1 - b1) * g + b1 * st["mu"][i]
            nu = (1 - b2) * (g * g) + b2 * st["nu"][i]
            st["mu"][i], st["nu"][i] = mu, nu
            if self.nesterov:
                mu_hat = (b1 * (mu / bias_correction(b1, count + 1))
                          + (1 - b1) * (g / bias_correction(b1, count)))
            else:
                mu_hat = mu / bias_correction(b1, count)
            if ro < self.threshold:
                out.append(mu_hat)
                continue
            nu_hat = nu / bias_correction(b2, count)
            out.append(float(radam_r(b2, ro)) * mu_hat / (
                torch.sqrt(nu_hat + self.eps_root) + self.eps))
        return out


class _Belief(_Adam):
    """``scale_by_belief`` (AdaBelief)."""

    def update(self, us, st, params, count, lr, ctx):
        b1, b2 = self.b1, self.b2
        out = []
        for i, g in enumerate(us):
            mu = (1 - b1) * g + b1 * st["mu"][i]
            err = g - mu
            nu = (1 - b2) * (err * err) + b2 * st["nu"][i] + self.eps_root
            st["mu"][i], st["nu"][i] = mu, nu
            if self.nesterov:
                mu_hat = (b1 * (mu / bias_correction(b1, count + 1))
                          + (1 - b1) * (g / bias_correction(b1, count)))
            else:
                mu_hat = mu / bias_correction(b1, count)
            out.append(mu_hat / (torch.sqrt(nu / bias_correction(b2, count))
                                 + self.eps))
        return out


class _Amsgrad(_Adam):
    """``scale_by_amsgrad``: Adam's moments and the running max of the
    corrected second moment."""

    def init(self, params):
        st = super().init(params)
        st["nu_max"] = [torch.zeros_like(p) for p in params]
        return st

    def update(self, us, st, params, count, lr, ctx):
        b1, b2 = self.b1, self.b2
        out = []
        for i, g in enumerate(us):
            mu = (1 - b1) * g + _decayed(b1, st["mu"][i], g)
            nu = (1 - b2) * (g * g) + b2 * st["nu"][i]
            nu_max = torch.maximum(st["nu_max"][i],
                                   nu / bias_correction(b2, count))
            out.append(mu / bias_correction(b1, count) / (
                torch.sqrt(nu_max + self.eps_root) + self.eps))
            st["mu"][i] = mu.to(st["mu"][i].dtype)
            st["nu"][i], st["nu_max"][i] = nu, nu_max
        return out


class _Adamax(_Transform):
    """``scale_by_adamax``: the first moment and the infinity norm."""

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(self, us, st, params, count, lr, ctx):
        out = []
        for i, g in enumerate(us):
            mu = (1 - self.b1) * g + self.b1 * st["mu"][i]
            nu = torch.maximum(g.abs() + self.eps, self.b2 * st["nu"][i])
            st["mu"][i], st["nu"][i] = mu, nu
            out.append(mu / bias_correction(self.b1, count) / nu)
        return out


class _Adan(_Transform):
    """``scale_by_adan`` (Algorithm 1 of arXiv:2208.06677v4)."""

    def __init__(self, b1, b2, b3, eps, eps_root):
        self.b1, self.b2, self.b3 = b1, b2, b3
        self.eps, self.eps_root = eps, eps_root

    def init(self, params):
        return {k: [torch.zeros_like(p) for p in params]
                for k in ("m", "v", "n", "g")}

    def update(self, us, st, params, count, lr, ctx):
        b1, b2, b3 = self.b1, self.b2, self.b3
        out = []
        for i, g in enumerate(us):
            diff = torch.zeros_like(g) if count == 1 else g - st["g"][i]
            m = (1 - b1) * g + b1 * st["m"][i]
            v = (1 - b2) * diff + b2 * st["v"][i]
            sq = g + (1 - b2) * diff
            n = (1 - b3) * (sq * sq) + b3 * st["n"][i]
            u = (m / bias_correction(b1, count)
                 + (1 - b2) * (v / bias_correction(b2, count)))
            out.append(u / (torch.sqrt(n / bias_correction(b3, count)
                                       + self.eps_root) + self.eps))
            st["m"][i], st["v"][i], st["n"][i], st["g"][i] = m, v, n, g
        return out


class _Yogi(_Transform):
    """``scale_by_yogi`` (``eps_root`` 0, both moments from 1e-6)."""

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {k: [torch.full_like(p, 1e-6) for p in params]
                for k in ("mu", "nu")}

    def update(self, us, st, params, count, lr, ctx):
        out = []
        for i, g in enumerate(us):
            mu = (1 - self.b1) * g + self.b1 * st["mu"][i]
            v, g2 = st["nu"][i], g * g
            nu = v - (1 - self.b2) * torch.sign(v - g2) * g2
            st["mu"][i], st["nu"][i] = mu, nu
            out.append(mu / bias_correction(self.b1, count) / (
                torch.sqrt(nu / bias_correction(self.b2, count)) + self.eps))
        return out


class _Novograd(_Transform):
    """``scale_by_novograd``: a second moment a parameter (its squared
    norm), the first from the normalised gradient plus decayed weights;
    the first step starts both."""

    def __init__(self, b1, b2, eps, eps_root, weight_decay):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.eps_root, self.wd = eps_root, weight_decay

    def init(self, params):
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros((), dtype=p.dtype, device=p.device)
                       for p in params]}

    def update(self, us, st, params, count, lr, ctx):
        out = []
        for i, (g, p) in enumerate(zip(us, params)):
            g_norm2 = torch.linalg.vector_norm(g) ** 2
            nu = g_norm2 if count == 1 else \
                (1 - self.b2) * g_norm2 + self.b2 * st["nu"][i]
            add = g / (torch.sqrt(nu + self.eps_root) + self.eps) \
                + self.wd * p
            mu = add if count == 1 else self.b1 * st["mu"][i] + add
            st["mu"][i], st["nu"][i] = mu, nu
            out.append(mu)
        return out


class _Lion(_Transform):
    """``scale_by_lion``."""

    def __init__(self, b1, b2, mu_dtype=None):
        self.b1, self.b2, self.mu_dtype = b1, b2, as_dtype(mu_dtype)

    def init(self, params):
        return {"mu": [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for p in params]}

    def update(self, us, st, params, count, lr, ctx):
        out = []
        for i, g in enumerate(us):
            m = st["mu"][i]
            out.append(torch.sign((1 - self.b1) * g + _decayed(self.b1, m, g)))
            st["mu"][i] = ((1 - self.b2) * g + _decayed(self.b2, m, g)).to(
                m.dtype)
        return out


class _Rms(_Transform):
    """``scale_by_rms`` or, ``centered``, ``scale_by_stddev``."""

    def __init__(self, decay, eps, initial_scale, eps_in_sqrt, centered,
                 bias_correction):
        self.decay, self.eps, self.initial = decay, eps, initial_scale
        self.eps_in_sqrt, self.centered = eps_in_sqrt, centered
        self.bias_correction = bias_correction

    def init(self, params):
        st = {"nu": [torch.full_like(p, self.initial) for p in params]}
        if self.centered:
            st["mu"] = [torch.zeros_like(p) for p in params]
        return st

    def update(self, us, st, params, count, lr, ctx):
        d = self.decay
        out = []
        for i, g in enumerate(us):
            nu = (1 - d) * (g * g) + d * st["nu"][i]
            st["nu"][i] = nu
            if self.centered:
                mu = (1 - d) * g + d * st["mu"][i]
                st["mu"][i] = mu
            if self.bias_correction:
                nu = nu / bias_correction(d, count)
                if self.centered:
                    mu = mu / bias_correction(d, count)
            if self.centered:
                nu = nu - mu * mu
            if self.eps_in_sqrt:
                out.append(torch.rsqrt(nu + self.eps) * g)
            else:
                out.append((1 / (torch.sqrt(nu) + self.eps)) * g)
        return out


class _Rss(_Transform):
    """``scale_by_rss`` (adagrad)."""

    def __init__(self, initial_accumulator_value, eps):
        self.initial, self.eps = initial_accumulator_value, eps

    def init(self, params):
        return {"sum_of_squares": [torch.full_like(p, self.initial)
                                   for p in params]}

    def update(self, us, st, params, count, lr, ctx):
        out = []
        for i, g in enumerate(us):
            ss = g * g + st["sum_of_squares"][i]
            st["sum_of_squares"][i] = ss
            out.append(torch.where(ss > 0, torch.rsqrt(ss + self.eps),
                                   torch.zeros_like(ss)) * g)
        return out


class _Adadelta(_Transform):
    """``scale_by_adadelta``."""

    def __init__(self, rho, eps):
        self.rho, self.eps = rho, eps

    def init(self, params):
        return {k: [torch.zeros_like(p) for p in params]
                for k in ("e_g", "e_x")}

    def update(self, us, st, params, count, lr, ctx):
        rho, eps = self.rho, self.eps
        out = []
        for i, g in enumerate(us):
            e_g = (1 - rho) * (g * g) + rho * st["e_g"][i]
            u = (torch.sqrt(st["e_x"][i] + eps) / torch.sqrt(e_g + eps)) * g
            st["e_g"][i] = e_g
            st["e_x"][i] = (1 - rho) * (u * u) + rho * st["e_x"][i]
            out.append(u)
        return out


class _FactoredRms(_Transform):
    """adafactor's ``scale_by_factored_rms``: the second moment factored
    into a row and a column mean over the two largest dims
    (:func:`factored_dims`), else kept whole; the decay ``1 - (step +
    1) ** -decay_rate``. The factored means keep their reduced dim (size
    1) here."""

    def __init__(self, factored, decay_rate, step_offset, min_dim, eps):
        self.factored, self.decay_rate = factored, decay_rate
        self.step_offset, self.min_dim, self.eps = step_offset, min_dim, eps

    def _dims(self, p):
        return factored_dims(p.shape, self.factored, self.min_dim)

    def init(self, params):
        st = {"v_row": [], "v_col": [], "v": []}
        for p in params:
            dims = self._dims(p)
            one = torch.zeros(1, dtype=p.dtype, device=p.device)
            if dims is None:
                st["v_row"].append(one)
                st["v_col"].append(one.clone())
                st["v"].append(torch.zeros_like(p))
                continue
            d1, d0 = dims
            st["v_row"].append(torch.zeros_like(p.sum(d0, keepdim=True)))
            st["v_col"].append(torch.zeros_like(p.sum(d1, keepdim=True)))
            st["v"].append(one.clone())
        return st

    def update(self, us, st, params, count, lr, ctx):
        t = np.float32(count - 1 - self.step_offset + 1)
        decay = float(np.float32(1.0) - np.float32(t ** np.float32(
            -self.decay_rate)))
        out = []
        for i, (g, p) in enumerate(zip(us, params)):
            g2 = g * g + self.eps
            dims = self._dims(p)
            if dims is None:
                v = decay * st["v"][i] + (1.0 - decay) * g2
                st["v"][i] = v
                out.append(g * v ** -0.5)
                continue
            d1, d0 = dims
            v_row = decay * st["v_row"][i] + (1.0 - decay) * g2.mean(
                d0, keepdim=True)
            v_col = decay * st["v_col"][i] + (1.0 - decay) * g2.mean(
                d1, keepdim=True)
            st["v_row"][i], st["v_col"][i] = v_row, v_col
            row_col_mean = v_row.mean(d1, keepdim=True)
            out.append(g * (v_row / row_col_mean) ** -0.5 * v_col ** -0.5)
        return out


class _ClipBlockRms(_Transform):
    """``clip_by_block_rms``."""

    def __init__(self, threshold):
        self.threshold = threshold

    def update(self, us, st, params, count, lr, ctx):
        return [u / torch.clamp_min(torch.sqrt(torch.mean(u * u))
                                    / self.threshold, 1.0) for u in us]


class _ParamBlockRms(_Transform):
    """``scale_by_param_block_rms``."""

    def update(self, us, st, params, count, lr, ctx):
        return [u * _rms(p, 1e-3) for u, p in zip(us, params)]


class _Ema(_Transform):
    """``ema`` without debiasing (adafactor's momentum)."""

    def __init__(self, decay, accumulator_dtype):
        self.decay, self.dtype = decay, as_dtype(accumulator_dtype)

    def init(self, params):
        return {"ema": [torch.zeros_like(p, dtype=self.dtype or p.dtype)
                        for p in params]}

    def update(self, us, st, params, count, lr, ctx):
        out = []
        for i, u in enumerate(us):
            e = (1 - self.decay) * u + _decayed(self.decay, st["ema"][i], u)
            st["ema"][i] = e.to(st["ema"][i].dtype)
            out.append(e)
        return out


class _Sm3(_Transform):
    """``scale_by_sm3`` (``b2`` 1): an accumulator a dim of each
    parameter, their elementwise minimum plus ``g ** 2`` the step's
    accumulator, then momentum. The accumulators are kept in the port's
    dim order (a min and a max over dims do not depend on it)."""

    def __init__(self, b1, eps=1e-8):
        self.b1, self.eps = b1, eps

    def init(self, params):
        return {"mu": [[torch.zeros(s, dtype=p.dtype, device=p.device)
                        for s in p.shape] for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(self, us, st, params, count, lr, ctx):
        out = []
        for i, g in enumerate(us):
            shaped = [m.reshape([1] * d + [-1] + [1] * (g.dim() - d - 1))
                      for d, m in enumerate(st["mu"][i])]
            low = shaped[0]
            for m in shaped[1:]:
                low = torch.minimum(low, m)
            accum = g * g + low
            inv = torch.where(accum > 0, torch.rsqrt(accum + self.eps),
                              torch.zeros_like(accum))
            nu = (1 - self.b1) * (g * inv) + self.b1 * st["nu"][i]
            st["nu"][i] = nu
            if g.dim() < 2:
                st["mu"][i] = [accum]
            else:
                st["mu"][i] = [accum.amax(dim=[a for a in range(g.dim())
                                                if a != d])
                               for d in range(g.dim())]
            out.append(nu)
        return out


class _TrustRatio(_Transform):
    """``scale_by_trust_ratio``: each update scaled by ``trust_coefficient
    * |p| / (|u| + eps)``, 1 where either norm is 0."""

    def __init__(self, min_norm=0.0, trust_coefficient=1.0, eps=0.0):
        self.min_norm, self.coef, self.eps = min_norm, trust_coefficient, eps

    def update(self, us, st, params, count, lr, ctx):
        out = []
        for u, p in zip(us, params):
            pn, un = _norm(p, self.min_norm), _norm(u, self.min_norm)
            ratio = self.coef * pn / (un + self.eps)
            out.append(u * torch.where((pn == 0) | (un == 0),
                                       torch.ones_like(ratio), ratio))
        return out


class _DecayedWeights(_Transform):
    """``add_decayed_weights``: ``u + weight_decay * p`` (``weight_decay``
    a float, or a function of the learning rate: fromage's)."""

    def __init__(self, weight_decay):
        self.wd = weight_decay

    def update(self, us, st, params, count, lr, ctx):
        wd = self.wd(lr) if callable(self.wd) else self.wd
        return [u + wd * p for u, p in zip(us, params)]


class _Masked(_Transform):
    """optax's ``masked`` around a stateless transform: applied to the
    parameters whose mask is true, the others' updates passed on."""

    def __init__(self, inner: _Transform, mask, option: str):
        self.inner, self.mask, self.option = inner, mask, option

    def update(self, us, st, params, count, lr, ctx):
        keep = _mask_bits(self.mask, ctx["names"], us, self.option)
        idx = [i for i, k in enumerate(keep) if k]
        new = self.inner.update([us[i] for i in idx], st,
                                [params[i] for i in idx], count, lr, ctx)
        out = list(us)
        for i, u in zip(idx, new):
            out[i] = u
        return out


class _Trace(_Transform):
    """``trace``: momentum (``nesterov``), the trace stored in
    ``accumulator_dtype``."""

    def __init__(self, decay, nesterov=False, accumulator_dtype=None):
        self.decay, self.nesterov = decay, nesterov
        self.dtype = as_dtype(accumulator_dtype)

    def init(self, params):
        return {"trace": [torch.zeros_like(p, dtype=self.dtype or p.dtype)
                          for p in params]}

    def update(self, us, st, params, count, lr, ctx):
        out = []
        for i, g in enumerate(us):
            t = g + _decayed(self.decay, st["trace"][i], g)
            out.append(g + self.decay * t if self.nesterov else t)
            st["trace"][i] = t.to(st["trace"][i].dtype)
        return out


class _Noise(_Transform):
    """``add_noise``: Gaussian noise of variance ``eta / count **
    gamma`` (float32), drawn from a ``torch.Generator`` seeded by
    ``seed``, one per device; its state is the transform's."""

    def __init__(self, eta, gamma, seed):
        self.eta, self.gamma, self.seed = eta, gamma, seed

    def init(self, params):
        return {"generator": [self._generator(p.device) for p in params[:1]]}

    def _generator(self, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        return gen.get_state()

    def update(self, us, st, params, count, lr, ctx):
        f = np.float32
        std = float(np.sqrt(f(self.eta) / f(f(count) ** f(self.gamma))))
        gen = torch.Generator(device=us[0].device) if us else None
        if gen is not None:
            gen.set_state(st["generator"][0])
        out = [u + std * torch.randn(u.shape, generator=gen, dtype=u.dtype,
                                     device=u.device) for u in us]
        if gen is not None:
            st["generator"][0] = gen.get_state()
        return out


class _Optimistic(_Transform):
    """``scale_by_optimistic_gradient``: ``(alpha + beta) * g - beta *
    g_prev``, ``g_prev = g`` at the first step."""

    def __init__(self, alpha, beta):
        self.alpha, self.beta = alpha, beta

    def init(self, params):
        return {"previous_gradient": [torch.zeros_like(p) for p in params]}

    def update(self, us, st, params, count, lr, ctx):
        alpha = self.alpha(lr) if callable(self.alpha) else self.alpha
        beta = self.beta(lr) if callable(self.beta) else self.beta
        out = []
        for i, g in enumerate(us):
            prev = g if count == 1 else st["previous_gradient"][i]
            out.append((alpha + beta) * g - beta * prev)
            st["previous_gradient"][i] = g
        return out


class _Rprop(_Transform):
    """``scale_by_rprop``: a step size an element, grown by ``eta_plus``
    while the gradient keeps its sign and shrunk by ``eta_minus`` (and
    that step skipped) when it flips; each update is the step the
    previous one chose, as optax applies it."""

    def __init__(self, lr0, eta_minus, eta_plus, min_step, max_step):
        self.lr0, self.eta_minus, self.eta_plus = lr0, eta_minus, eta_plus
        self.min_step, self.max_step = min_step, max_step

    def init(self, params):
        return {"step_sizes": [torch.full_like(p, self.lr0) for p in params],
                "prev_updates": [torch.zeros_like(p) for p in params]}

    def update(self, us, st, params, count, lr, ctx):
        out = []
        for i, g in enumerate(us):
            sign = g * st["prev_updates"][i]
            size = st["step_sizes"][i]
            grown = torch.clamp(size * torch.where(
                sign > 0, self.eta_plus, self.eta_minus),
                min=self.min_step, max=self.max_step)
            size = torch.where(sign == 0, size, grown)
            old = st["prev_updates"][i]
            st["step_sizes"][i] = size
            st["prev_updates"][i] = torch.where(
                sign < 0, torch.zeros_like(g), size * torch.sign(g))
            # optax's update is the previous step's (its third map reads
            # the state's prev_updates), zero where the sign flipped
            out.append(torch.where(sign < 0, torch.zeros_like(old), old))
        return out


class _Sign(_Transform):
    def update(self, us, st, params, count, lr, ctx):
        return [torch.sign(u) for u in us]


class _Scale(_Transform):
    """``scale`` by a constant, or by a function of the learning rate
    (``scale_by_learning_rate``: ``-lr``)."""

    def __init__(self, factor):
        self.factor = factor

    def update(self, us, st, params, count, lr, ctx):
        k = self.factor(lr) if callable(self.factor) else self.factor
        return [u * k for u in us]


def _mask_bits(mask, names: List[str], values: List[torch.Tensor],
               option: str) -> List[bool]:
    """A mask option as one bool a parameter: a bool for all, a dict of
    bools by name (every name), or a callable over ``{name: tensor}``
    returning one of these."""
    if callable(mask):
        mask = mask(dict(zip(names, values)))
    if isinstance(mask, bool):
        return [mask] * len(names)
    if isinstance(mask, dict):
        if set(mask) != set(names):
            raise ValueError(
                f"{option}: a bool for every parameter, by name; missing "
                f"{sorted(set(names) - set(mask))}, unknown "
                f"{sorted(set(mask) - set(names))}")
        return [bool(mask[n]) for n in names]
    raise TypeError(f"{option}: a bool, a dict of bools by parameter name "
                    f"or a callable returning one, not {type(mask)}")


def _decay(wd, mask, option="mask") -> _Transform:
    inner = _DecayedWeights(wd)
    return inner if mask is None else _Masked(inner, mask, option)


def _by_lr(sign: float = -1.0) -> _Transform:
    return _Scale(lambda lr: sign * lr)


def _chain(name: str, o: Dict[str, Any], lr0: float) -> List[_Transform]:
    """The factory's optax ``chain``, transform for transform."""
    adam = ("b1", "b2", "eps", "eps_root", "mu_dtype", "nesterov")
    if name in ("adam", "nadam"):
        return [_Adam(*(o[k] for k in adam)), _by_lr()]
    if name in ("adamw", "nadamw"):
        return [_Adam(*(o[k] for k in adam)),
                _decay(o["weight_decay"], o["mask"]), _by_lr()]
    if name == "amsgrad":
        return [_Amsgrad(o["b1"], o["b2"], o["eps"], o["eps_root"],
                         o["mu_dtype"]), _by_lr()]
    if name == "adamaxw":
        return [_Adamax(o["b1"], o["b2"], o["eps"]),
                _decay(o["weight_decay"], o["mask"]), _by_lr()]
    if name == "adan":
        return [_Adan(o["b1"], o["b2"], o["b3"], o["eps"], o["eps_root"]),
                _decay(o["weight_decay"], o["mask"]), _by_lr()]
    if name == "radam":
        return [_Radam(o["b1"], o["b2"], o["eps"], o["eps_root"],
                       o["threshold"], o["nesterov"]), _by_lr()]
    if name == "adabelief":
        return [_Belief(o["b1"], o["b2"], o["eps"], o["eps_root"],
                        nesterov=o["nesterov"]), _by_lr()]
    if name == "yogi":
        return [_Yogi(o["b1"], o["b2"], o["eps"]), _by_lr()]
    if name == "lamb":
        return [_Adam(o["b1"], o["b2"], o["eps"], o["eps_root"]),
                _decay(o["weight_decay"], o["mask"]), _TrustRatio(),
                _by_lr()]
    if name == "novograd":
        return [_Novograd(o["b1"], o["b2"], o["eps"], o["eps_root"],
                          o["weight_decay"]), _by_lr()]
    if name == "lion":
        return [_Lion(o["b1"], o["b2"], o["mu_dtype"]),
                _decay(o["weight_decay"], o["mask"]), _by_lr()]
    if name == "rmsprop":
        chain = [_Rms(o["decay"], o["eps"], o["initial_scale"],
                      o["eps_in_sqrt"], o["centered"],
                      o["bias_correction"]), _by_lr()]
        if o["momentum"] is not None:
            chain.append(_Trace(o["momentum"], o["nesterov"]))
        return chain
    if name == "adagrad":
        return [_Rss(o["initial_accumulator_value"], o["eps"]), _by_lr()]
    if name == "adadelta":
        return [_decay(o["weight_decay"], o["weight_decay_mask"],
                       "weight_decay_mask"),
                _Adadelta(o["rho"], o["eps"]), _by_lr()]
    if name == "adafactor":
        chain = [_FactoredRms(o["factored"], o["decay_rate"],
                              o["decay_offset"], o["min_dim_size_to_factor"],
                              o["eps"])]
        if o["clipping_threshold"] is not None:
            chain.append(_ClipBlockRms(o["clipping_threshold"]))
        chain.append(_by_lr(1.0))
        if o["multiply_by_parameter_scale"]:
            chain.append(_ParamBlockRms())
        if o["momentum"] is not None:
            chain.append(_Ema(o["momentum"], o["dtype_momentum"]))
        if o["weight_decay_rate"] is not None:
            chain.append(_decay(o["weight_decay_rate"],
                                o["weight_decay_mask"], "weight_decay_mask"))
        return chain + [_Scale(-1.0)]
    if name == "sm3":
        return [_Sm3(o["momentum"]), _Scale(-lr0)]
    if name == "fromage":
        def mult(lr):
            return float(np.float32(1.0) / np.sqrt(np.float32(1 + lr ** 2)))

        return [_TrustRatio(o["min_norm"]),
                _Scale(lambda lr: -float(np.float32(lr * mult(lr)))),
                _DecayedWeights(lambda lr: mult(lr) - 1)]
    if name == "lars":
        return [_decay(o["weight_decay"], o["weight_decay_mask"],
                       "weight_decay_mask"),
                _Masked(_TrustRatio(trust_coefficient=o["trust_coefficient"],
                                    eps=o["eps"]),
                        o["trust_ratio_mask"], "trust_ratio_mask"),
                _by_lr(), _Trace(o["momentum"], o["nesterov"])]
    if name == "sgd":
        chain = [] if o["momentum"] is None else [
            _Trace(o["momentum"], o["nesterov"], o["accumulator_dtype"])]
        return chain + [_by_lr()]
    if name == "noisy_sgd":
        if o["key"] is not None and o["seed"] is not None:
            raise ValueError("Only one of seed or key can be specified.")
        seed = o["seed"] if o["key"] is None else o["key"]
        return [_Noise(o["eta"], o["gamma"], int(seed or 0)), _by_lr()]
    if name == "sign_sgd":
        return [_Sign(), _by_lr()]
    if name == "rprop":
        return [_Rprop(lr0, o["eta_minus"], o["eta_plus"],
                       o["min_step_size"], o["max_step_size"]), _Scale(-1.0)]
    if name == "optimistic_gradient_descent":
        return [_Optimistic(o["alpha"], o["beta"]), _by_lr()]
    if name == "optimistic_adam":
        beta = lr0 if o["optimism"] is None else o["optimism"]
        return [_Adam(*(o[k] for k in adam)), _Optimistic(lr0, beta),
                _Scale(-1.0)]
    if name == "optimistic_adam_v2":
        return [_Adam(*(o[k] for k in adam)),
                _Optimistic(o["alpha"], o["beta"]), _by_lr()]
    if name in NEEDS_VALUE:
        return []
    raise AssertionError(name)


class Rule:
    """One optax factory's update on a list of parameters.

    :meth:`step` takes the gradients (already averaged and clipped by the
    chain) and the learning rate of this update, and updates the
    parameters in place. ``count`` is the factory's own update count
    (its bias corrections). ``names``: the parameters' names, which the
    mask options read (default their positions). ``learning_rate``: a
    float or a function of the update count, as optax's; ``rprop``,
    ``sm3`` and ``optimistic_adam`` take only a float, which they keep."""

    def __init__(self, name: str, params: List[torch.Tensor],
                 kwargs: Dict[str, Any],
                 learning_rate: Union[float, Callable[[int], float]],
                 names: Optional[List[str]] = None):
        if name not in FACTORIES:
            raise ValueError(f"unknown optimizer {name!r} (any optax 0.2.6 "
                             f"factory name: {sorted(FACTORIES)} or "
                             "'adamax')")
        unknown = sorted(set(kwargs) - set(FACTORIES[name]))
        if unknown:
            raise TypeError(f"{name}() got unexpected keyword arguments "
                            f"{unknown}")
        if name in FLOAT_LR and callable(learning_rate):
            raise TypeError(f"{name} takes a float learning rate, not a "
                            "schedule (as optax's does)")
        self.name = name
        self.opts = {**FACTORIES[name], **kwargs}
        self.names = list(names) if names is not None else [
            str(i) for i in range(len(params))]
        self.count = 0
        lr0 = learning_rate(0) if callable(learning_rate) \
            else learning_rate
        self.chain = _chain(name, self.opts, lr0)
        self.states = [t.init(list(params)) for t in self.chain]

    def check(self) -> None:
        """Raise where optax's update would: ``lbfgs`` and ``polyak_sgd``
        need the loss value, which the trainer's update does not pass."""
        if self.name in NEEDS_VALUE:
            raise TypeError(f"{self.name}: {NEEDS_VALUE[self.name]}, which "
                            "the trainer's update(grads, state, params) does "
                            "not pass (as under JAX's trainer)")

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             lr: float) -> None:
        count = self.count + 1
        ctx = {"names": self.names}
        us = list(grads)
        for t, st in zip(self.chain, self.states):
            us = t.update(us, st, params, count, lr, ctx)
        for p, u in zip(params, us):
            p.add_(u)
        self.count = count

    def tensors(self) -> List[torch.Tensor]:
        out = []

        def walk(v):
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    walk(x)

        for st in self.states:
            for v in st.values():
                walk(v)
        return out

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "state": self.states}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        def moved(v, like):
            if isinstance(like, torch.Tensor):
                # a generator's state stays a CPU byte tensor
                return v.to(like.device)
            return [moved(a, b) for a, b in zip(v, like)]

        self.count = int(state["count"])
        self.states = [{k: moved(v, st[k]) for k, v in saved.items()}
                       for saved, st in zip(state["state"], self.states)]
