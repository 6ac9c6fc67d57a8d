"""Line-by-line extinction: tiled Voigt cross-section synthesis.

Replacement for the reference's extinction.c/opacity.c (reference:
SURVEY.md section 2.2): instead of tabulating Voigt profiles on a
wnosamp-oversampled grid and accumulating per line on the CPU, we
bucket lines onto wavenumber tiles (host, once) and evaluate the
Voigt function *directly* for every (condition, line, gridpoint)
triple on the device — dense and static-shaped.  The profile and the
line sum are plain XLA (see ``_line_sum`` for how they are split).

Pipeline:

1. ``tile_lines``          host: bucket a LineList onto tiles of the
                           output wn grid with a wing-reach cutoff,
                           padded to a static per-tile line count.
2. ``cross_section_grid``  device: sigma[cond, nwave] cm^2/molecule
                           for a batch of (T, p) conditions.

Line strength follows the HITRAN convention:

  S(T) = S296 * Q(296)/Q(T) * exp(-c2 E''/T)/exp(-c2 E''/296)
               * (1-exp(-c2 wn0/T))/(1-exp(-c2 wn0/296))

Broadening modes:

* ``collision``: Lorentz HWHM from collision theory against an H2/He
  bath (reference parity: scripts/broadening.py:91-127), line-independent
  per condition.
* ``air``: HITRAN gamma_air*(p/1atm)*(296/T)^n_air per line.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp

from bart_tpu import constants as const
from bart_tpu.linelist.hitran import TREF, LineList
from bart_tpu.linelist.molecules import get_molecule
from bart_tpu.linelist.tips import partition_function
from bart_tpu.physics.voigt import faddeeva_real

__all__ = [
    "LineTiles",
    "BroadeningSpec",
    "tile_lines",
    "tile_lines_bucketed",
    "cross_section_grid",
    "cross_section_tiles",
    "wing_cutoff",
]

_SQRT_2LN2 = float(np.sqrt(2.0 * np.log(2.0)))
_INV_SQRT_PI = float(1.0 / np.sqrt(np.pi))
_ATM_BARYE = 1.01325e6  # 1 atm in barye


@dataclasses.dataclass(frozen=True)
class BroadeningSpec:
    """Lorentz-broadening configuration.

    mode='collision' reproduces the reference's H2/He collision-theory
    widths with the *baseline* atmosphere's H2/He mixing ratios (the
    reference builds its opacity grid from the initial atm file;
    SURVEY.md section 2.2).  mode='air' uses HITRAN air widths.
    """

    mode: str = "collision"          # 'collision' | 'air'
    q_h2: float = 0.85
    q_he: float = 0.15

    @classmethod
    def from_abundances(cls, species, abundances, mode: str = "collision"
                        ) -> "BroadeningSpec":
        """Collision-broadening bath from the baseline atmosphere's own
        H2/He mixing ratios (the reference reads these columns from the
        atm file: code/BARTfunc.py:189-201; scripts/broadening.py uses
        the same fractions).  Mean over layers; falls back to the
        0.85/0.15 defaults when either collider is absent."""
        sp = list(species)
        q = np.asarray(abundances, np.float64)
        if "H2" in sp and "He" in sp:
            qh2 = float(np.mean(q[:, sp.index("H2")]))
            qhe = float(np.mean(q[:, sp.index("He")]))
            if qh2 > 0.0 or qhe > 0.0:
                return cls(mode=mode, q_h2=qh2, q_he=qhe)
        return cls(mode=mode)

    def gamma_lorentz(self, lines: "LineTiles", mass_g: float, diam_cm: float,
                      T, p_barye):
        """Lorentz HWHM [cm-1]; T,p arrays broadcast against line axes."""
        if self.mode == "collision":
            h2 = get_molecule("H2")
            he = get_molecule("He")
            coll = (
                self.q_h2
                * ((diam_cm + h2.diameter * 1e-8) * 0.5) ** 2
                * np.sqrt(1.0 / mass_g + 1.0 / (h2.mass * const.AMU))
                + self.q_he
                * ((diam_cm + he.diameter * 1e-8) * 0.5) ** 2
                * np.sqrt(1.0 / mass_g + 1.0 / (he.mass * const.AMU))
            )
            gamma = (
                np.sqrt(2.0)
                / const.C_LIGHT
                / jnp.sqrt(T * np.pi * const.K_BOLTZ)
                * p_barye
                * coll
            )
            return gamma[..., None, None]  # broadcast over (tile, line)
        elif self.mode == "air":
            p_atm = p_barye / _ATM_BARYE
            return (
                lines.gamma_air[None, ...]
                * p_atm[..., None, None]
                * (TREF / T)[..., None, None] ** lines.n_air[None, ...]
            )
        raise ValueError(f"unknown broadening mode {self.mode!r}")


@dataclasses.dataclass
class LineTiles:
    """Lines bucketed per output-grid tile (static shapes).

    Arrays are [n_tiles, max_lines_per_tile]; ``weight`` is 0 for
    padding slots.  ``wn_tiles`` is the output grid reshaped to
    [n_tiles, tile_size] (padded with the last grid value).
    """

    species: str
    wn_tiles: jax.Array    # [nt, W]
    grid_mask: jax.Array   # [nt, W] bool, False on grid padding
    wn0: jax.Array         # [nt, L]
    s296: jax.Array        # [nt, L]
    elower: jax.Array      # [nt, L]
    gamma_air: jax.Array   # [nt, L]
    n_air: jax.Array       # [nt, L]
    weight: jax.Array      # [nt, L] 1/0 padding mask
    cutoff: float          # wing reach used for bucketing [cm-1]
    n_grid: int            # original grid length

    @property
    def shape(self):
        return (self.wn0.shape[0], self.wn0.shape[1], self.wn_tiles.shape[1])


def wing_cutoff(
    nwidth: float,
    wn_max: float,
    t_min: float,
    p_max_barye: float,
    mass_g: float,
    diam_cm: float,
    spec: BroadeningSpec,
    cutoff_max: float = 25.0,
) -> float:
    """Maximum line-wing reach [cm-1]: nwidth x the largest HWHM over
    the (T, p) domain, clamped to ``cutoff_max`` (HITRAN-standard 25
    cm-1 far-wing truncation).  The reference's reach is
    nwidth*max(HWHM) with no clamp (voigt.c semantics)."""
    # Doppler largest at wn_max and high T — but Lorentz dominates the
    # max at p_max, t_min:
    from bart_tpu.physics.voigt import doppler_hwhm, lorentz_hwhm_collision

    h2 = get_molecule("H2")
    he = get_molecule("He")
    gl = float(
        lorentz_hwhm_collision(
            p_max_barye, t_min, mass_g, diam_cm,
            np.array([spec.q_h2, spec.q_he]),
            np.array([h2.mass, he.mass]) * const.AMU,
            np.array([h2.diameter, he.diameter]) * 1e-8,
        )
    )
    gd = float(doppler_hwhm(wn_max, 4000.0, mass_g))
    return float(min(nwidth * max(gl, gd), cutoff_max))


def tile_lines(
    lines: LineList,
    wn_grid: np.ndarray,
    cutoff: float,
    tile_size: int = 256,
    pad_lines_to: int = 128,
    ethresh: float = 0.0,
) -> LineTiles:
    """Bucket lines onto wn-grid tiles (host-side, runs once).

    Each tile of ``tile_size`` grid points receives every line whose
    center lies within ``cutoff`` of the tile's span.  Per-tile counts
    are padded up to a common multiple of ``pad_lines_to``.

    ``ethresh`` > 0 culls lines weaker than ethresh x max(S296) BEFORE
    bucketing (the reference's extinction.c line-strength cutoff,
    applied at tiling time so culled lines cost neither memory nor
    Voigt evaluations; WASP-12b cfg uses ethresh 1e-99 = keep all,
    demo cfg 1e-6).
    """
    if ethresh > 0 and lines.nlines:
        lines = lines.cull(ethresh)
    wn_grid = np.asarray(wn_grid, np.float64)
    n = len(wn_grid)
    nt = -(-n // tile_size)
    npad = nt * tile_size - n
    wn_padded = np.concatenate([wn_grid, np.full(npad, wn_grid[-1])])
    grid_mask = np.concatenate([np.ones(n, bool), np.zeros(npad, bool)])
    wn_tiles = wn_padded.reshape(nt, tile_size)
    grid_mask = grid_mask.reshape(nt, tile_size)

    lo = np.searchsorted(lines.wn0, wn_tiles[:, 0] - cutoff)
    hi = np.searchsorted(lines.wn0, wn_tiles[:, -1] + cutoff)
    counts = hi - lo
    max_l = int(counts.max()) if nt else 0
    max_l = max(pad_lines_to, -(-max_l // pad_lines_to) * pad_lines_to)

    idx = lo[:, None] + np.arange(max_l)[None, :]
    weight = (idx < hi[:, None]).astype(np.float64)
    idx = np.clip(idx, 0, max(lines.nlines - 1, 0))

    if lines.nlines == 0:
        z = np.zeros((nt, max_l))
        return LineTiles(
            lines.species, jnp.asarray(wn_tiles), jnp.asarray(grid_mask),
            jnp.asarray(z), jnp.asarray(z), jnp.asarray(z), jnp.asarray(z),
            jnp.asarray(z), jnp.asarray(z), cutoff, n,
        )

    return LineTiles(
        species=lines.species,
        wn_tiles=jnp.asarray(wn_tiles),
        grid_mask=jnp.asarray(grid_mask),
        wn0=jnp.asarray(lines.wn0[idx]),
        s296=jnp.asarray(lines.s296[idx]),
        elower=jnp.asarray(lines.elower[idx]),
        gamma_air=jnp.asarray(lines.gamma_air[idx]),
        n_air=jnp.asarray(lines.n_air[idx]),
        weight=jnp.asarray(weight),
        cutoff=cutoff,
        n_grid=n,
    )


def tile_lines_bucketed(
    lines: LineList,
    wn_grid: np.ndarray,
    cutoff: float,
    tile_size: int = 256,
    pad_lines_to: int = 128,
    ethresh: float = 0.0,
) -> list[tuple[np.ndarray, LineTiles]]:
    """Variable-depth tiling: tiles grouped into geometric depth
    classes so per-tile padding is bounded by 2x instead of the global
    max (uniform tiling pads EVERY tile to the deepest tile's line
    count — measured 2.4-7x Voigt-work inflation under HITEMP-like
    band-head density skew; SURVEY.md 7 "lines per bin vary wildly").

    Returns [(tile_indices, LineTiles), ...] where each LineTiles
    covers only the listed tiles, padded to that class's depth.
    Reassemble per-tile outputs with the tile indices
    (opacity.grid.build_opacity_grid does this for the table build).
    """
    if ethresh > 0 and lines.nlines:
        lines = lines.cull(ethresh)
    wn_grid = np.asarray(wn_grid, np.float64)
    n = len(wn_grid)
    nt = -(-n // tile_size)
    npad = nt * tile_size - n
    wn_padded = np.concatenate([wn_grid, np.full(npad, wn_grid[-1])])
    grid_mask = np.concatenate([np.ones(n, bool), np.zeros(npad, bool)])
    wn_tiles = wn_padded.reshape(nt, tile_size)
    grid_mask = grid_mask.reshape(nt, tile_size)

    lo = np.searchsorted(lines.wn0, wn_tiles[:, 0] - cutoff)
    hi = np.searchsorted(lines.wn0, wn_tiles[:, -1] + cutoff)
    counts = hi - lo

    # geometric classes (bounds the number of compiled programs at
    # ~log2 of the depth range); each class pads to ITS OWN max count
    # rounded to pad_lines_to, not the geometric bound
    class_of = np.ceil(
        np.log2(np.maximum(counts, 1) / pad_lines_to)
    ).clip(min=0).astype(int)
    out = []
    for cls in np.unique(class_of):
        sel = np.where(class_of == cls)[0]
        max_l = int(max(counts[sel].max(), 1))
        max_l = -(-max_l // pad_lines_to) * pad_lines_to
        idx = lo[sel][:, None] + np.arange(max_l)[None, :]
        weight = (idx < hi[sel][:, None]).astype(np.float64)
        idx = np.clip(idx, 0, max(lines.nlines - 1, 0))
        if lines.nlines == 0:
            z = np.zeros((len(sel), max_l))
            tiles = LineTiles(
                lines.species, jnp.asarray(wn_tiles[sel]),
                jnp.asarray(grid_mask[sel]), jnp.asarray(z), jnp.asarray(z),
                jnp.asarray(z), jnp.asarray(z), jnp.asarray(z),
                jnp.asarray(z), cutoff, n,
            )
        else:
            tiles = LineTiles(
                species=lines.species,
                wn_tiles=jnp.asarray(wn_tiles[sel]),
                grid_mask=jnp.asarray(grid_mask[sel]),
                wn0=jnp.asarray(lines.wn0[idx]),
                s296=jnp.asarray(lines.s296[idx]),
                elower=jnp.asarray(lines.elower[idx]),
                gamma_air=jnp.asarray(lines.gamma_air[idx]),
                n_air=jnp.asarray(lines.n_air[idx]),
                weight=jnp.asarray(weight),
                cutoff=cutoff,
                n_grid=n,
            )
        out.append((sel, tiles))
    return out


def _line_strength(tiles: LineTiles, T, q_fn: Callable):
    """S(T) per line [cond..., nt, L] (HITRAN convention)."""
    c2 = const.C2
    Tb = T[..., None, None]
    qr = (q_fn(jnp.asarray(TREF)) / q_fn(T))[..., None, None]
    boltz = jnp.exp(-c2 * tiles.elower * (1.0 / Tb - 1.0 / TREF))
    # Padding slots have wn0=0 -> 0/0 in the stimulated-emission factor;
    # substitute a safe center (their weight is 0 anyway).
    wn0 = jnp.where(tiles.weight > 0, tiles.wn0, 1000.0)
    stim = (1.0 - jnp.exp(-c2 * wn0 / Tb)) / (1.0 - jnp.exp(-c2 * wn0 / TREF))
    return tiles.s296 * qr * boltz * stim * tiles.weight


def _line_sum(sw, prof):
    """sigma[nt, W] = sum_l sw[nt, l] prof[nt, l, W].

    ``prof`` is materialized first (optimization barrier): with the
    Faddeeva series fused into the reduction, XLA's GPU compiler spent
    9 minutes on that one kernel at demo width (100 layers x 27 T x
    2501 bins x 30k lines, on an H100); apart, each part compiles in
    seconds.  The build's dispatch budget already sizes batches for
    materialized [cond, nt, L, W] temporaries.
    """
    prof = jax.lax.optimization_barrier(prof)
    return jnp.sum(sw[:, :, None] * prof, axis=1)


def cross_section_tiles(
    tiles: LineTiles,
    T: jax.Array,
    p_barye: jax.Array,
    spec: BroadeningSpec,
    nwidth: float = 0.0,
    q_table=None,
    osamp: int = 1,
    wndelt: float = 1.0,
) -> jax.Array:
    """Per-tile cross-sections sigma[cond, nt, W] in cm^2/molecule
    (building block for variable-depth tile buckets, whose per-tile
    outputs the caller reassembles by index; ``cross_section_grid``
    is the flattened single-tiling view).

    ``T``/``p_barye`` are 1-D condition batches (e.g. layers, or a
    flattened (T_grid x p_grid) for table builds).  ``nwidth`` > 0
    applies the reference's per-line profile truncation at
    nwidth*max(doppler, lorentz) HWHM (voigt.c semantics); 0 keeps
    full wings out to the bucketing cutoff.

    ``osamp`` > 1 returns the *bin-averaged* cross-section: for every
    (line, bin) pair the Voigt profile is integrated over the
    ``wndelt``-wide bin around each output gridpoint with an
    ``osamp``-point midpoint rule in arctan-transformed coordinates
    x = HWHM_voigt * tan(theta).  The substitution is exact for a
    Lorentzian and resolves a Doppler core of ANY width with ~16
    points, unlike uniform sub-sampling which would need the
    reference's wnosamp~2160 fine grid (examples/demo/BART_eclipse.cfg;
    makesample.c semantics).  osamp=1 is exact point-sampling at the
    output wavenumbers (line centers are never snapped to a grid,
    unlike the reference).

    WARNING: a bin-averaged sigma fed through exp(-tau) is curve-of-
    growth BIASED for saturated lines (measured: -1.3% eclipse / -7%
    transit band fluxes at demo scale) — for band-flux fidelity use the
    pipeline-level ``rtosamp`` instead.  docs/LINE_SAMPLING.md has the
    full study.
    """
    mol = get_molecule(tiles.species)
    mass_g = mol.mass * const.AMU
    diam_cm = mol.diameter * 1e-8
    q_fn = partition_function(tiles.species, q_table)

    osamp = int(osamp)

    def per_cond(T_c, p_c):
        # [nt, L] line quantities
        s = _line_strength(tiles, T_c, q_fn)
        gd = (
            tiles.wn0
            / const.C_LIGHT
            * jnp.sqrt(2.0 * np.log(2.0) * const.K_BOLTZ * T_c / mass_g)
        )  # Doppler HWHM
        # Padding slots have wn0=0 -> gd=0; guard against 1/0 -> NaN
        # (their contribution is zeroed by `weight` below).
        sigma_g = jnp.where(tiles.weight > 0, gd, 1.0) / _SQRT_2LN2
        gl = spec.gamma_lorentz(tiles, mass_g, diam_cm, T_c, p_c)[0]
        gl = jnp.broadcast_to(gl, tiles.wn0.shape)

        inv = 1.0 / (sigma_g * jnp.sqrt(2.0))
        y = gl * inv  # [nt, L]

        w = tiles.weight
        if osamp > 1:
            # bin-averaged profile: midpoint rule in arctan-transformed
            # coordinates x = HWHM_V * tan(theta) — exact for a
            # Lorentzian, resolves a Doppler core of any width
            dxa = (tiles.wn_tiles[:, None, :] - 0.5 * wndelt
                   - tiles.wn0[:, :, None])                    # [nt, L, W]
            dxb = dxa + wndelt
            # Voigt HWHM (Olivero & Longbothum) as the quadrature scale
            wv = jnp.maximum(
                0.5346 * gl + jnp.sqrt(0.2166 * gl * gl + gd * gd), 1e-12
            )[:, :, None]
            ta = jnp.arctan(dxa / wv)
            dt = (jnp.arctan(dxb / wv) - ta) / osamp
            k = jnp.arange(osamp, dtype=dxa.dtype) + 0.5
            theta = ta[..., None] + dt[..., None] * k          # [nt,L,W,K]
            tan_t = jnp.tan(theta)
            x_off = wv[..., None] * tan_t                      # wn offsets
            x = x_off * inv[:, :, None, None]
            prof = (faddeeva_real(x, y[:, :, None, None])
                    * (inv * _INV_SQRT_PI)[:, :, None, None])
            if nwidth > 0:
                reach = nwidth * jnp.maximum(gd, gl)
                prof = prof * (jnp.abs(x_off) <= reach[:, :, None, None])
            # bin integral = sum prof * wv*(1+tan^2)*dtheta; average /bin
            prof = jax.lax.optimization_barrier(prof)
            avg = (jnp.sum(prof * (1.0 + tan_t * tan_t), axis=-1)
                   * wv * dt / wndelt)                         # [nt, L, W]
            return _line_sum(s * w, avg)                       # [nt, W]

        # [nt, L, W] offsets: exact point sampling at the gridpoints
        dx = tiles.wn_tiles[:, None, :] - tiles.wn0[:, :, None]
        x = dx * inv[:, :, None]
        prof = faddeeva_real(x, y[:, :, None]) * (inv * _INV_SQRT_PI)[:, :, None]

        if nwidth > 0:
            reach = nwidth * jnp.maximum(gd, gl)
            prof = prof * (jnp.abs(dx) <= reach[:, :, None])
        # the barrier keeps the Faddeeva series out of the line-sum
        # reduction: fused into one reduce kernel it took the GPU
        # compiler minutes (see _line_sum)
        return _line_sum(s * w, prof)                          # [nt, W]

    return jax.vmap(per_cond)(T, p_barye)  # [cond, nt, W]


def cross_section_grid(
    tiles: LineTiles,
    T: jax.Array,
    p_barye: jax.Array,
    spec: BroadeningSpec,
    nwidth: float = 0.0,
    q_table=None,
    batch_tiles: int = 0,
    osamp: int = 1,
    wndelt: float = 1.0,
) -> jax.Array:
    """Cross-section sigma[cond, n_grid] in cm^2/molecule — the
    flattened-to-grid view of ``cross_section_tiles`` (see that
    function for the full semantics of every argument)."""
    sig_tiles = cross_section_tiles(
        tiles, T, p_barye, spec, nwidth=nwidth, q_table=q_table,
        osamp=osamp, wndelt=wndelt,
    )
    ncond = T.shape[0]
    return sig_tiles.reshape(ncond, -1)[:, : tiles.n_grid]
