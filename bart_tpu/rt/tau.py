"""Optical-depth integration for both ray geometries (jit/vmap-safe).

Equivalent of the reference's tau.c/slantpath.c and the vertical path
of eclipse.c (reference: SURVEY.md section 2.2).  The reference's
``toomuch`` early exit becomes masked saturation: every layer is
computed (static shapes), and downstream consumers clamp at tau_max —
on an accelerator the uniform computation beats a data-dependent exit.

Conventions: layers top-first (index 0 = lowest pressure), radius
descending [cm], extinction [cm-1] per (layer, wn).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["tau_vertical", "tau_slant", "slant_chords", "TAU_CLAMP"]

# Saturation value standing in for the reference's `toomuch` cutoff:
# exp(-88) underflows f32, so deeper layers contribute exactly zero.
TAU_CLAMP = 88.0


def tau_vertical(extinction: jax.Array, radius_cm: jax.Array) -> jax.Array:
    """Vertical optical depth from the top: tau[layer, wn].

    tau_l = sum_{k<l} 0.5 (e_k + e_{k+1}) (r_k - r_{k+1}); tau_0 = 0.
    Trapezoidal, matching the reference's cumulative integration
    (eclipse.c vertical path).

    The cumulative sum runs over the (short) layer axis of a
    [layer, wn] block; XLA may lower cumsum to a log-depth scan that
    re-reads the whole block ~log2(L) times.  A triangular matmul
    computes the same prefix sums in ONE pass at full f32 accuracy
    (precision=HIGHEST: no reduced-precision inputs, which on the GPU
    means no TF32).
    """
    dr = radius_cm[:-1] - radius_cm[1:]                       # [L-1] > 0
    seg = 0.5 * (extinction[:-1] + extinction[1:]) * dr[:, None]
    tri = jnp.tril(jnp.ones((seg.shape[0], seg.shape[0]), seg.dtype))
    tau = jax.lax.dot_general(
        tri, seg, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.concatenate([jnp.zeros_like(tau[:1]), tau], axis=0)


def slant_chords(radius_cm: jax.Array) -> jax.Array:
    """Chord coordinates x[i, k] = sqrt(r_k^2 - b_i^2) (0 where
    r_k < b_i), with impact parameters b_i = r_i (descending radii).

    f32-stable factored form: r_k^2 - r_i^2 = (d_k - d_i)(r_k + r_i)
    with d = r - r[-1].  The naive r_k^2 - r_i^2 loses ~half the f32
    mantissa to cancellation (r ~ 7e9 cm, layer spacing ~1e6 cm) and —
    worse — XLA's fma contraction makes the i == k diagonal a NONZERO
    square-rounding residual (~ulp(r^2)/2 = 2e12, i.e. a spurious
    ~14 km tangent chord), so eager and jitted geometry disagreed at
    the percent level in transit depth.  Here the only subtraction is
    between the small anchored deltas (<= atmosphere height ~1e8 cm):
    exactly rounded, exactly zero on the diagonal under any fusion."""
    delta = radius_cm - radius_cm[-1]
    h = jnp.maximum(delta[None, :] - delta[:, None], 0.0)
    s = radius_cm[None, :] + radius_cm[:, None]
    return jnp.sqrt(h * s)


def tau_slant(extinction: jax.Array, radius_cm: jax.Array) -> jax.Array:
    """Slant-path optical depth per impact parameter: tau[b, wn].

    Impact parameters are the layer radii themselves (transit's choice:
    one ray grazing each layer).  Change of variable x = sqrt(r^2-b^2)
    turns the path integral 2*int e(r) r dr / sqrt(r^2-b^2) into
    2*int e dx — trapezoid over the x grid, fully dense/masked (no
    per-ray ragged loops; slantpath.c equivalent).
    """
    # x[i, k] = path coordinate of layer k along ray i (0 when r_k < b_i),
    # in the f32-stable factored form (see slant_chords)
    x = slant_chords(radius_cm)
    # segment lengths between consecutive layers along each ray
    dx = x[:, :-1] - x[:, 1:]                                  # [L, L-1] >= 0
    emid = 0.5 * (extinction[:-1] + extinction[1:])            # [L-1, wn]
    # tau_i = 2 * sum_k dx[i, k] * emid[k]  — a matmul over the layer
    # axis (HIGHEST: full f32 products — the default precision may
    # use TF32 on the GPU, three decimal digits, which truncates tau)
    return 2.0 * jnp.einsum("ik,kw->iw", dx, emid,
                            precision=jax.lax.Precision.HIGHEST)
