"""Eclipse (dayside emission) spectrum synthesis.

Equivalent of the reference's eclipse.c (reference: SURVEY.md section
2.2): emergent intensity along a set of ray angles from the
Planck-weighted optical-depth integral, then flux as the quadrature
F = 2 pi int I(mu) mu dmu over the ``raygrid`` angles.

Formulation (per wn, per mu): the emergent intensity of a
plane-parallel, non-scattering atmosphere

    I(mu) = sum_layers B(T_l) e^{-tau_l/mu} dtau_l/mu
            + B(T_bot) e^{-tau_bot/mu}

with the boundary term making the isothermal limit exact
(I -> B(T), F -> pi B(T)) for any tau — the analytic check the
reference can only approach with its `toomuch` cutoff.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from bart_tpu.rt.planck import planck_wn
from bart_tpu.rt.tau import TAU_CLAMP

__all__ = ["eclipse_intensity", "eclipse_flux", "raygrid_weights",
           "expsum_weights"]


# Exponential-sum quadrature of the angular integral
#   E3(tau) = int_0^1 e^{-tau/mu} mu dmu  ~=  sum_m a_m e^{-m tau},
# i.e. nodes mu_m = 1/m with weights w_m = m * a_m in the (mu, w)
# contract F = 2 pi sum w_m mu_m I(mu_m).  Constrained least-squares
# fit over tau in [0, 60] with sum a_m = E3(0) = 1/2 EXACT (isothermal
# limit F = pi B preserved); regenerated against scipy.special.expn in
# tests/test_rt.py.  Accuracy vs the exact E3: M=8 -> 9.3e-5 max abs
# (the reference's 5-angle `raygrid 0 20 40 60 80` trapezoid carries
# 6.0e-3, and angle grids plateau at 2.6e-3 because they truncate the
# mu -> 0 corner at the last angle).  Because the nodes are 1/m, the
# attenuation sum is a POLYNOMIAL in u = e^{-tau}: the fused kernels
# (rt.fused powers mode) evaluate it with ONE exponential + M fused
# multiply-adds instead of M exponentials.  M > 8 is counterproductive
# in f32: the fitted coefficients grow (|a| ~ 6e3 at M=12) and their
# cancellation floor exceeds the fit error.
_EXPSUM_A = {
    4: (1.61335934078130794e-01, 4.88550756927762009e-01,
        -4.07055615912562785e-01, 2.57168924906669982e-01),
    6: (1.47012763339087416e-01, 7.19438102862494544e-01,
        -1.55504909139625247e+00, 2.68410535882847823e+00,
        -2.29259268782271342e+00, 7.97085554188905698e-01),
    8: (1.37265647678806169e-01, 9.92469095570294391e-01,
        -4.02223479276460694e+00, 1.30181210122982343e+01,
        -2.51569208626538448e+01, 2.83933133356001832e+01,
        -1.71813168685346263e+01, 4.31930343280555995e+00),
}


def expsum_weights(n: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """(mu, w) for the exponential-sum angular quadrature (see
    _EXPSUM_A): mu = [1, 1/2, ..., 1/n], with w such that
    w_m mu_m = a_m.  Drop-in for raygrid_weights wherever the (mu, w)
    quadrature contract is consumed; additionally enables the fused
    kernels' single-exponential powers mode."""
    if n not in _EXPSUM_A:
        raise ValueError(
            f"expsum quadrature supports n in {sorted(_EXPSUM_A)}, "
            f"got {n}")
    a = np.asarray(_EXPSUM_A[n], np.float64)
    m = np.arange(1, n + 1, dtype=np.float64)
    return 1.0 / m, a * m


def eclipse_intensity(
    tau: jax.Array, temperature: jax.Array, wn: jax.Array, mu: jax.Array
) -> jax.Array:
    """Emergent intensity I[mu, wn] from tau[layer, wn] and T[layer]."""
    tau = jnp.minimum(tau, TAU_CLAMP)
    B = planck_wn(wn[None, :], temperature[:, None])           # [L, wn]
    # Per-segment exact integral with B constant in the segment:
    #   int B e^{-t/mu} dt/mu = B (e^{-tau_l/mu} - e^{-tau_{l+1}/mu})
    # — the "emission = sum B * d(transmission)" form, robust for
    # optically thick layers where a dtau trapezoid fails — PLUS the
    # surface term B_bot e^{-tau_bot/mu}, rewritten by summation by
    # parts so the attenuation tensor has exactly ONE consumer:
    #   I = sum_l e^{-tau_l/mu} C_l,
    #   C_0 = Bmid_0, C_l = Bmid_l - Bmid_{l-1}, C_{L-1} = B_{L-1} - Bmid_{L-2}.
    # XLA then fuses the exp into the layer reduction instead of
    # materializing the [mu, layer, wn] block in device memory.
    if B.shape[0] == 1:   # single-layer slab: I = B e^{-tau/mu}
        return B * jnp.exp(-tau / mu[:, None, None])[:, 0, :]
    Bmid = 0.5 * (B[1:] + B[:-1])                              # [L-1, wn]
    C = jnp.concatenate(
        [Bmid[:1], Bmid[1:] - Bmid[:-1], B[-1:] - Bmid[-1:]], axis=0
    )                                                          # [L, wn]
    neg_inv_mu = -1.0 / mu
    atten = jnp.exp(tau[None, :, :] * neg_inv_mu[:, None, None])
    return jnp.einsum("mlw,lw->mw", atten, C,
                      precision=jax.lax.Precision.HIGHEST)


def raygrid_weights(angles_deg) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature (mu, w) for F = 2 pi sum w_i I(mu_i) mu_i from a grid
    of ray angles in degrees (reference raygrid, demo '0 20 40 60 80').

    Trapezoidal in mu over [0, 1]: the angle grid is augmented with the
    mu=0 endpoint (I(mu->0) mu -> 0) so the weights integrate exactly.
    """
    mu = np.sort(np.cos(np.deg2rad(np.asarray(angles_deg, np.float64))))
    # augment with the mu=0 endpoint (I(mu) mu -> 0 there), then take
    # trapezoid weights on [0, mu_1, ..., mu_n], dropping the 0 node:
    grid = np.concatenate([[0.0], mu])
    tw = np.zeros(len(grid))
    tw[0] = 0.5 * (grid[1] - grid[0])
    tw[-1] = 0.5 * (grid[-1] - grid[-2])
    tw[1:-1] = 0.5 * (grid[2:] - grid[:-2])
    return mu, tw[1:]


def eclipse_flux(
    tau: jax.Array,
    temperature: jax.Array,
    wn: jax.Array,
    mu: jax.Array,
    weights: jax.Array,
) -> jax.Array:
    """Hemispheric flux F[wn] = 2 pi sum_i w_i I(mu_i) mu_i
    [erg s-1 cm-2 / cm-1]."""
    I = eclipse_intensity(tau, temperature, wn, mu)
    return 2.0 * jnp.pi * jnp.einsum("m,mw->w", weights * mu, I)
