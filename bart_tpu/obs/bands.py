"""Band integration: filters as one dense matmul.

Replaces the reference's per-filter ragged index sets + trapz loop
(reference: code/wine.py:127-199 resample/bandintegrate;
code/BARTfunc.py:236-296, 385-396) with a precomputed weight matrix
W[nfilt, nwave] such that

    bandflux = W @ spectrum

is numerically identical to the reference's
trapz(spectrum * nifilter, specwn[band]) per filter — including the
filter normalization and, for eclipse geometry, the stellar-flux
division and (Rp/Rs)^2 factor folded into W.  One matmul instead
of nfilt host-side loops.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["BandMatrix", "build_band_matrix", "band_integrate"]


@dataclasses.dataclass
class BandMatrix:
    """Dense band-integration operator (device array)."""

    weights: jax.Array     # [nfilt, nwave]
    nfilters: int


def _trapz_weights(x: np.ndarray) -> np.ndarray:
    w = np.zeros_like(x)
    w[0] = 0.5 * (x[1] - x[0])
    w[-1] = 0.5 * (x[-1] - x[-2])
    w[1:-1] = 0.5 * (x[2:] - x[:-2])
    return w


def build_band_matrix(
    spec_wn: np.ndarray,
    filters: list[tuple[np.ndarray, np.ndarray]],
    star_flux: np.ndarray | None = None,
    rprs: float | None = None,
    dtype=None,
) -> BandMatrix:
    """Precompute W (host, once).

    ``filters`` is a list of (filter_wn, transmission) ascending arrays.
    With ``star_flux`` (on spec_wn) and ``rprs`` given, the eclipse
    flux-ratio conversion fluxrat = spec/star * rprs^2 is folded in
    (reference code/BARTfunc.py:387-390); otherwise W integrates the
    raw spectrum (transit/direct geometry, :391-396).

    Raises ValueError if a filter extends beyond the spectrum grid
    (reference BARTfunc.py:259-263 exits).
    """
    spec_wn = np.asarray(spec_wn, np.float64)
    nwave = len(spec_wn)
    W = np.zeros((len(filters), nwave))
    for i, (fwn, ftr) in enumerate(filters):
        if fwn[0] < spec_wn[0] or fwn[-1] > spec_wn[-1]:
            raise ValueError(
                f"Wavenumber array ({spec_wn[0]:.2f} - {spec_wn[-1]:.2f} "
                f"cm-1) does not cover the filter[{i}] range "
                f"({fwn[0]:.2f} - {fwn[-1]:.2f} cm-1)."
            )
        # reference band indices: specwn < fwn[-1] and specwn > fwn[0]
        idx = np.where((spec_wn < fwn[-1]) & (spec_wn > fwn[0]))[0]
        x = spec_wn[idx]
        ifilter = np.interp(x, fwn, ftr)
        tw = _trapz_weights(x)
        norm = np.sum(ifilter * tw)  # = trapz(ifilter, x)
        nifilter = ifilter / norm
        row = nifilter * tw
        if star_flux is not None:
            row = row * (rprs**2) / np.asarray(star_flux)[idx]
        W[i, idx] = row
    return BandMatrix(weights=jnp.asarray(W, dtype), nfilters=len(filters))


def band_integrate(bands, spectrum: jax.Array) -> jax.Array:
    """bandflux[..., nfilt] = spectrum[..., nwave] @ W.T (one matmul).

    ``bands`` is a BandMatrix or a raw weight array (the forward model
    passes its — possibly padded/sharded — tables copy).

    precision=HIGHEST: the default precision may round f32 operands
    (TF32 on the GPU keeps ~3 decimal digits), a ~1e-3 systematic on
    band fluxes — too coarse for chi^2 against percent-level eclipse
    depths.  The matmul is tiny ([nwave] x [nwave, nfilt]), so full
    precision is free.
    """
    w = bands.weights if isinstance(bands, BandMatrix) else bands
    return jnp.matmul(spectrum, w.T, precision=jax.lax.Precision.HIGHEST)
