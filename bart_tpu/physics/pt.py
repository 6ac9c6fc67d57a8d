"""Temperature-pressure profile models (pure JAX, jit/vmap-safe).

Re-implements the six parametric PT models of the reference BART
(reference: code/PT.py:157-855) as pure JAX functions:

- ``pt_inversion``    Madhusudhan & Seager (2009) inverted, 6 params
                      (reference code/PT.py:157-380)
- ``pt_no_inversion`` Madhusudhan & Seager (2009) non-inverted, 5 params
                      (reference code/PT.py:384-586)
- ``pt_line``         Line et al. (2013) 3-channel Eddington, 5 params,
                      optional Thorngren et al. (2019) internal temperature
                      (reference code/PT.py:589-701)
- ``pt_iso``          isothermal (reference code/PT.py:704-719)
- ``pt_adiabatic``    naive adiabat (reference code/PT.py:741-749)
- ``pt_piette``       Piette & Madhusudhan (2020) 8-param difference spline
                      (reference code/PT.py:752-812)

Differences from the reference, by design:

* All functions are pure, differentiable, and jit/vmap-safe: no
  data-dependent Python control flow, static shapes throughout.
* Non-physical parameter combinations do not raise.  Each model returns
  ``(T, valid)`` where ``valid`` is a boolean scalar; the sampler maps
  invalid draws to log-likelihood ``-inf`` (the reference instead raised
  ValueError / replied with -1 sentinels, reference code/BARTfunc.py:319-330).
* Gaussian smoothing reproduces ``scipy.ndimage.gaussian_filter1d``
  (sigma=4, mode='nearest') with an explicit convolution.

Convention: pressure arrays are ordered top-of-atmosphere first
(ascending pressure), equally spaced in log10.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from bart_tpu import constants as const

__all__ = [
    "gaussian_smooth",
    "pt_inversion",
    "pt_no_inversion",
    "pt_line",
    "pt_iso",
    "pt_adiabatic",
    "pt_piette",
    "PT_MODELS",
    "pt_generator",
    "n_pt_params",
]


def gaussian_smooth(x: jax.Array, sigma, truncate: float = 4.0) -> jax.Array:
    """1-D Gaussian filter matching scipy.ndimage.gaussian_filter1d.

    mode='nearest' boundary handling (edge replication).  ``sigma`` must be
    a static Python float (it fixes the kernel radius, hence the shapes).
    """
    sigma = float(sigma)
    if sigma <= 0:
        return x
    radius = int(truncate * sigma + 0.5)
    if radius == 0:
        return x
    t = jnp.arange(-radius, radius + 1, dtype=x.dtype)
    kernel = jnp.exp(-0.5 * (t / sigma) ** 2)
    kernel = kernel / jnp.sum(kernel)
    xp = jnp.concatenate(
        [jnp.full((radius,), x[0], x.dtype), x, jnp.full((radius,), x[-1], x.dtype)]
    )
    # correlate == convolve for a symmetric kernel
    return jnp.convolve(xp, kernel, mode="valid")


def _region_fill(p, T_l1, T_mid_pos, T_mid_neg, T_l3, p1, p2, p3):
    """Select per-layer temperature by pressure region (inversion case)."""
    T = jnp.where(p < p1, T_l1, jnp.where(p < p2, T_mid_pos, jnp.where(p < p3, T_mid_neg, T_l3)))
    return T


def pt_inversion(p: jax.Array, a1, a2, p1, p2, p3, T3, smooth: bool = True):
    """Madhu & Seager (2009) Eq. 2, thermal-inversion case.

    Parameters a1,a2 are the exponential factors; p1<p2<p3 the layer
    boundary pressures (bar); T3 the deep isothermal temperature.
    Returns (T[K] per layer, valid flag).
    Reference: code/PT.py:157-380 (formulas at :320-370).
    """
    p0 = jnp.min(p)
    T2 = T3 - (jnp.log(p3 / p2) / a2) ** 2
    T0 = T2 + (jnp.log(p1 / p2) / -a2) ** 2 - (jnp.log(p1 / p0) / a1) ** 2
    T1 = T0 + (jnp.log(p1 / p0) / a1) ** 2

    T_l1 = (jnp.log(p / p0) / a1) ** 2 + T0
    T_l2_pos = (jnp.log(p / p2) / -a2) ** 2 + T2
    T_l2_neg = (jnp.log(p / p2) / a2) ** 2 + T2
    T_l3 = jnp.full_like(p, T3)

    T = _region_fill(p, T_l1, T_l2_pos, T_l2_neg, T_l3, p1, p2, p3)
    valid = (T0 > 0) & (T1 > 0) & (T2 > 0) & (T3 > 0) & (p1 < p2) & (p2 < p3)
    if smooth:
        T = gaussian_smooth(T, 4.0)
    return T, valid


def pt_no_inversion(p: jax.Array, a1, a2, p1, p3, T3, smooth: bool = True):
    """Madhu & Seager (2009) Eq. 2, non-inversion case (5 params).

    Reference: code/PT.py:384-586 (formulas at :535-584).
    """
    p0 = jnp.min(p)
    T1 = T3 - (jnp.log(p3 / p1) / a2) ** 2
    T0 = T1 - (jnp.log(p1 / p0) / a1) ** 2

    T_l1 = (jnp.log(p / p0) / a1) ** 2 + T0
    T_l2 = (jnp.log(p / p1) / a2) ** 2 + T1
    T_l3 = jnp.full_like(p, T3)

    T = jnp.where(p < p1, T_l1, jnp.where(p < p3, T_l2, T_l3))
    valid = (T0 > 0) & (T1 > 0) & (T3 > 0) & (p1 < p3)
    if smooth:
        T = gaussian_smooth(T, 4.0)
    return T, valid


_EULER_GAMMA = 0.5772156649015329


def _exp1(x):
    """Exponential integral E1(x), x > 0, branch-free fixed-work.

    jax.scipy.special.exp1 is pathologically slow on some backends
    (~800 ms for a 40-element f64 array on CPU), so we evaluate it
    directly: power series  -gamma - ln x + sum (-1)^{k+1} x^k/(k k!)
    for x <= 1 (24 terms, ~1e-16), and the Lentz continued fraction
    exp(-x)/(x+1/(1+1/(x+2/(1+2/...)))) evaluated bottom-up at fixed
    depth for x > 1.  Both branches are computed and selected with
    `where` — cheap, vectorized, differentiable.
    """
    xs = jnp.where(x > 0, x, 1.0)

    # --- series branch (x <= 1) ---
    xc = jnp.minimum(xs, 1.0)
    term = jnp.ones_like(xc)
    acc = jnp.zeros_like(xc)
    for k in range(1, 25):
        term = term * xc / k
        acc = acc + (term / k if k % 2 == 1 else -term / k)
    series = -_EULER_GAMMA - jnp.log(xc) + acc

    # --- continued-fraction branch (x > 1), bottom-up fixed depth ---
    xf = jnp.maximum(xs, 1.0)
    cf = jnp.zeros_like(xf)
    for k in range(30, 0, -1):
        cf = k / (1.0 + k / (xf + cf))
    frac = jnp.exp(-xf) / (xf + cf)

    return jnp.where(x <= 1.0, series, frac)


def _expn2(x):
    """Exponential integral E2(x) = exp(-x) - x*E1(x), E2(0)=1."""
    safe = jnp.where(x > 0, x, 1.0)
    e2 = jnp.exp(-safe) - safe * _exp1(safe)
    return jnp.where(x > 0, e2, 1.0)


def _xi(gamma, tau):
    """Line et al. (2013) Eq. 14.  Reference: code/PT.py:722-739."""
    gt = gamma * tau
    return (2.0 / 3.0) * (
        1.0
        + (1.0 / gamma) * (1.0 + (0.5 * gt - 1.0) * jnp.exp(-gt))
        + gamma * (1.0 - 0.5 * tau**2) * _expn2(gt)
    )


def pt_line(
    p: jax.Array,
    log_kappa,
    log_gamma1,
    log_gamma2,
    alpha,
    beta,
    R_star,
    T_star,
    T_int,
    sma,
    grav,
    T_int_type: str = "const",
):
    """Line et al. (2013) Eqs. 13-16 gray 3-channel Eddington profile.

    ``log_kappa/log_gamma1/log_gamma2`` in log10; ``R_star``/``sma`` in
    meters, ``T_star``/``T_int`` in K, ``grav`` in cm s-2.  With
    ``T_int_type='thorngren'`` the internal temperature follows
    Thorngren et al. (2019).  Reference: code/PT.py:589-701.
    Returns (T, valid) — always valid (model is smooth in its params).
    """
    kappa = 10.0**log_kappa
    gamma1 = 10.0**log_gamma1
    gamma2 = 10.0**log_gamma2

    if T_int_type == "thorngren":
        T_eq = jnp.sqrt(R_star / (2.0 * sma)) * T_star
        F = 4.0 * const.SIGMA_SB * T_eq**4
        T_int = 1.24 * T_eq * jnp.exp(-((jnp.log(F) - 0.14) ** 2) / 2.96)

    T_irr = beta * jnp.sqrt(R_star / (2.0 * sma)) * T_star
    tau = kappa * (p * const.BAR_TO_BARYE) / grav

    xi1 = _xi(gamma1, tau)
    xi2 = _xi(gamma2, tau)

    T4 = 0.75 * (
        T_int**4 * (2.0 / 3.0 + tau)
        + T_irr**4 * (1.0 - alpha) * xi1
        + T_irr**4 * alpha * xi2
    )
    T = T4**0.25
    return T, jnp.asarray(True)


def pt_iso(p: jax.Array, T):
    """Isothermal profile.  Reference: code/PT.py:704-719."""
    return jnp.full_like(p, T), jnp.asarray(True)


def pt_adiabatic(p: jax.Array, T0, gamma, logp0):
    """Naive adiabat.  Reference: code/PT.py:741-749."""
    p0 = 10.0**logp0
    T = T0 / (1.0 + (gamma - 1.0) / gamma * jnp.log(p0 / p))
    return T, jnp.all(T > 0)


def pt_piette(p: jax.Array, T0, dTbot_32, dT32_10, dT10_0, dT0_1, dT1_01, dT01_001, dT001_top):
    """Piette & Madhusudhan (2020) "SPT" difference-parameterized profile.

    Anchors at layers nearest {top, 0.01, 0.1, 1, 3.2, 10, 32, bottom} bar,
    linear interpolation in log10(p), then Gaussian smoothing with
    sigma = 0.3 dex.  Reference: code/PT.py:752-812.
    """
    logp = jnp.log10(p)
    i_top = jnp.argmin(p)
    i_001 = jnp.argmin(jnp.abs(p - 0.01))
    i_01 = jnp.argmin(jnp.abs(p - 0.1))
    i_1 = jnp.argmin(jnp.abs(p - 1.0))
    i_0 = jnp.argmin(jnp.abs(p - 3.2))
    i_10 = jnp.argmin(jnp.abs(p - 10.0))
    i_32 = jnp.argmin(jnp.abs(p - 32.0))
    i_bot = jnp.argmax(p)

    T_0 = T0
    T_10 = T0 + dT10_0
    T_32 = T_10 + dT32_10
    T_bot = T_32 + dTbot_32
    T_1 = T0 - dT0_1
    T_01 = T_1 - dT1_01
    T_001 = T_01 - dT01_001
    T_top = T_001 - dT001_top

    anchor_idx = jnp.stack([i_top, i_001, i_01, i_1, i_0, i_10, i_32, i_bot])
    anchor_T = jnp.stack([T_top, T_001, T_01, T_1, T_0, T_10, T_32, T_bot])
    anchor_lp = logp[anchor_idx]

    # Linear interpolation in log10(p); anchors are already sorted by p.
    T = jnp.interp(logp, anchor_lp, anchor_T)

    # sigma = 0.3 dex expressed in layers (static: grid spacing is static)
    # The reference computes sig from the first two grid points at trace
    # time; we require the caller pass a log-uniform grid.
    dlp = jnp.abs(logp[0] - logp[1])
    # dlp is traced; to keep the kernel static we smooth with the value
    # implied by a log-uniform grid. Use stop_gradient scalar via python
    # float when available; fall back to sigma computed from array size.
    T = _smooth_traced_sigma(T, dlp)
    valid = jnp.all(T > 0)
    return T, valid


def _smooth_traced_sigma(x, dlp, max_radius: int = 64):
    """Gaussian smooth where sigma = 0.3/dlp is a traced scalar.

    Builds a fixed-radius kernel and masks it: shapes stay static under
    jit while matching scipy's gaussian_filter1d(mode='nearest') for any
    radius <= max_radius.
    """
    sigma = 0.3 / dlp
    radius_f = jnp.floor(4.0 * sigma + 0.5)
    t = jnp.arange(-max_radius, max_radius + 1, dtype=x.dtype)
    kernel = jnp.exp(-0.5 * (t / sigma) ** 2)
    kernel = jnp.where(jnp.abs(t) <= radius_f, kernel, 0.0)
    kernel = kernel / jnp.sum(kernel)
    xp = jnp.concatenate(
        [jnp.full((max_radius,), x[0], x.dtype), x, jnp.full((max_radius,), x[-1], x.dtype)]
    )
    return jnp.convolve(xp, kernel, mode="valid")


# --- Dispatcher ----------------------------------------------------------

#: Number of free parameters per PT model type (reference parameter
#: layout, code/BARTfunc.py:173-179 with makecfg PTtype naming).
n_pt_params = {
    "iso": 1,
    "line": 5,
    "madhu_noinv": 5,
    "madhu_inv": 6,
    "adiabatic": 3,
    "piette": 8,
}

PT_MODELS: dict[str, Callable] = {
    "iso": pt_iso,
    "line": pt_line,
    "madhu_noinv": pt_no_inversion,
    "madhu_inv": pt_inversion,
    "adiabatic": pt_adiabatic,
    "piette": pt_piette,
}


def pt_generator(p: jax.Array, free_params, pt_type: str, pt_args=None):
    """Dispatch a PT model by name (reference code/PT.py:815-855).

    ``free_params`` is a 1-D array of the model's free parameters;
    ``pt_args`` the extra fixed arguments (only for 'line':
    [R_star, T_star, T_int, sma, grav, T_int_type]).
    Returns (T, valid).
    """
    fn = PT_MODELS[pt_type]
    n = n_pt_params[pt_type]
    params = [free_params[i] for i in range(n)]
    if pt_args is not None:
        return fn(p, *params, *pt_args)
    return fn(p, *params)
