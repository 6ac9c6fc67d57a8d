"""Opacity grid: precomputed cross-section table + runtime T-interpolation.

Equivalent of the reference's opacity-table machinery (transit
``--justOpacity`` build; extinction.c runtime interpolation; SURVEY.md
sections 2.2/3.3): a 4-D table sigma[mol, T, layer, wn] in
cm^2/molecule built once offline, then interpolated at the per-layer
sampled temperatures inside the MCMC hot loop.

The reference shares the table across MPI workers via POSIX SHM
(shareOpacity); here the table is a device array — under multi-chip
sharding it is sharded along the wavenumber axis (bart_tpu.parallel).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from bart_tpu.linelist.hitran import LineList
from bart_tpu.opacity.extinction import (
    BroadeningSpec,
    cross_section_tiles,
    tile_lines_bucketed,
    wing_cutoff,
)

__all__ = ["OpacityGrid", "build_opacity_grid", "interp_opacity",
           "save_grid", "load_grid", "fine_bin_mask"]


def fine_bin_mask(sigma_fine: np.ndarray, K: int, delta: float = 0.02,
                  floor: float = 1e-12) -> np.ndarray:
    """Which output bins need in-bin fine resolution? -> bool[Wout].

    Static adaptive resolution for the folded-rtosamp kernels
    (rt.fused): a bin is SMOOTH when, for every table row (molecule x
    T-node) and layer, the in-bin relative deviation from the bin mean
    is <= ``delta``.  Running smooth bins at K=1 on the bin-MEAN
    cross-section makes the first-order sampling error vanish exactly
    (avg_k tau_k == taubar by construction); the residual is the
    curvature term  |avg_k e^-tau - e^-taubar| <= 1/2 Var(tau) e^-taubar
    <= 0.27 delta^2  (max of tau^2 e^-tau), i.e. <= 1.1e-4 at the
    default delta — the same error class as rtosamp=32 itself.  Rows
    whose bin mean is below ``floor`` times the row's global maximum
    cannot contribute resolvable optical depth and are ignored.

    In-bin structure is bimodal in practice (a bin either contains a
    line core/shoulder or only smooth wings + continuum), so the mask
    is insensitive to ``delta`` over decades; at demo line densities
    ~40-45%% of bins are fine, giving ~2.3x hot-loop speedup at
    unchanged measured band error (tests/test_fused.py).
    """
    sig = np.asarray(sigma_fine)
    if sig.ndim == 3:
        sig = sig[None]
    M, nT, L, Wf = sig.shape
    W = Wf // K
    if W * K != Wf:
        raise ValueError(f"fine wn axis {Wf} is not a multiple of K={K}")
    fine = np.zeros(W, bool)
    gmax = sig.max(axis=(1, 2, 3))                   # per molecule
    # scan one (molecule, T-node) plane at a time: the deviation
    # temporaries are then [L, W, K] (~tens of MB) instead of the full
    # fine table x2 (several GB at K=32 production scale)
    for m in range(M):
        for it in range(nT):
            s = sig[m, it].reshape(L, W, K)
            sbar = s.mean(-1)
            dev = np.abs(s - sbar[..., None]).max(-1)
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.where(
                    sbar > 0, dev / np.where(sbar > 0, sbar, 1.0), 0.0)
            negligible = sbar <= floor * gmax[m]
            fine |= ((rel > delta) & ~negligible).any(axis=0)
    return fine


@dataclasses.dataclass
class OpacityGrid:
    """sigma[mol, nT, nlayer, nwave] in cm^2/molecule (f32 on device)."""

    species: list[str]
    t_grid: np.ndarray       # [nT], uniform ascending
    pressure: np.ndarray     # [nlayer] in bar, ascending (top-first)
    wn_grid: np.ndarray      # [nwave] cm-1, ascending
    sigma: jax.Array         # [nmol, nT, nlayer, nwave]

    @property
    def t_min(self) -> float:
        return float(self.t_grid[0])

    @property
    def t_step(self) -> float:
        return float(self.t_grid[1] - self.t_grid[0])


def build_opacity_grid(
    lines_by_species: dict[str, LineList],
    wn_grid: np.ndarray,
    t_grid: np.ndarray,
    pressure_bar: np.ndarray,
    spec: BroadeningSpec | None = None,
    nwidth: float = 20.0,
    ethresh: float = 0.0,
    tile_size: int = 256,
    cond_batch: int = 32,
    dtype=jnp.float32,
    q_tables: dict | None = None,
    osamp: int = 1,
    dispatch_budget_bytes: float = 2e9,
) -> OpacityGrid:
    """Build the opacity table (the --justOpacity stage,
    reference BART.py:560-569 / SURVEY.md 3.3).

    Conditions (T x layer) are flattened and processed in batches of
    ``cond_batch`` through the tiled cross-section kernel.
    ``ethresh`` culls lines below that fraction of the strongest line
    (reference ethresh semantics).  ``osamp`` > 1 stores bin-averaged
    cross-sections — curve-of-growth biased for saturated lines; for
    band-flux fidelity build the table on an rtosamp-refined wn_grid
    instead (measured trade-offs: docs/LINE_SAMPLING.md).
    """
    from bart_tpu import constants as const
    from bart_tpu.linelist.molecules import get_molecule

    spec = spec or BroadeningSpec()
    t_grid = np.asarray(t_grid, np.float64)
    pressure_bar = np.asarray(pressure_bar, np.float64)
    nT, nP, nW = len(t_grid), len(pressure_bar), len(wn_grid)

    TT, PP = np.meshgrid(t_grid, pressure_bar, indexing="ij")
    conds_T = TT.ravel()
    conds_p = PP.ravel() * const.BAR_TO_BARYE
    ncond = conds_T.size

    species = list(lines_by_species)
    sigma = np.zeros((len(species), ncond, nW), np.float32)

    nWp = -(-nW // tile_size) * tile_size
    for im, name in enumerate(species):
        ll = lines_by_species[name]
        mol = get_molecule(name)
        cutoff = wing_cutoff(
            nwidth, float(wn_grid[-1]), float(t_grid[0]),
            float(pressure_bar[-1]) * const.BAR_TO_BARYE,
            mol.mass * const.AMU, mol.diameter * 1e-8, spec,
        )
        # Variable-depth tile buckets: geometric depth classes bound
        # the per-tile padding at 2x where uniform tiling pays the
        # deepest tile's line count everywhere (2.4-7x measured under
        # HITEMP-like band-head skew; docs/LINE_SAMPLING.md findings).
        buckets = tile_lines_bucketed(
            ll, wn_grid, cutoff, tile_size=tile_size, ethresh=ethresh,
        )
        q_table = (q_tables or {}).get(name)

        # One compiled program per depth class: lax.map over condition
        # batches (sequential on device, so peak memory stays one
        # batch) — a single dispatch instead of ncond/cond_batch
        # round-trips through the host.
        nb = -(-ncond // cond_batch)
        tb = np.full(nb * cond_batch, conds_T[-1])
        pb = np.full(nb * cond_batch, conds_p[-1])
        tb[:ncond] = conds_T
        pb[:ncond] = conds_p
        tb = jnp.asarray(tb.reshape(nb, cond_batch))
        pb = jnp.asarray(pb.reshape(nb, cond_batch))

        wndelt = float(wn_grid[1] - wn_grid[0]) if nW > 1 else 1.0
        out = np.zeros((ncond, nWp), np.float32)
        expanded = []
        for tile_idx, tiles in buckets:
            # Depth chunking: cross-sections are ADDITIVE over lines,
            # so a bucket whose depth makes even ONE condition's
            # temporaries exceed the budget (3M-line band heads reach
            # ~7e5 slots/tile = ~22 GB, more than a device holds)
            # is split along the line-depth axis and the partial
            # sigmas summed.
            nt_b, L_b = tiles.wn0.shape
            L_cap = max(int(dispatch_budget_bytes
                            // max(6 * nt_b * tile_size * 4, 1)), 1)
            if L_b > L_cap:
                nseg = -(-L_b // L_cap)
                for s in range(nseg):
                    sl = slice(s * L_cap, (s + 1) * L_cap)
                    expanded.append((tile_idx, dataclasses.replace(
                        tiles, wn0=tiles.wn0[:, sl],
                        s296=tiles.s296[:, sl], elower=tiles.elower[:, sl],
                        gamma_air=tiles.gamma_air[:, sl],
                        n_air=tiles.n_air[:, sl],
                        weight=tiles.weight[:, sl])))
            else:
                expanded.append((tile_idx, tiles))
        for tile_idx, tiles in expanded:
            # Cap the per-dispatch footprint: the Voigt chain peaks at
            # ~6 f32 temporaries of [cond, nt, L, W] under XLA fusion;
            # an uncapped cond_batch overflows HBM.  Budget ~2 GB.
            nt_b, L_b = tiles.wn0.shape
            per_cond = 6 * nt_b * L_b * tile_size * 4
            cb_eff = max(1, min(cond_batch,
                                int(dispatch_budget_bytes
                                    // max(per_cond, 1))))
            if cb_eff != cond_batch:
                nb_b = -(-ncond // cb_eff)
                tb_b = np.full(nb_b * cb_eff, conds_T[-1])
                pb_b = np.full(nb_b * cb_eff, conds_p[-1])
                tb_b[:ncond] = conds_T
                pb_b[:ncond] = conds_p
                tb_b = jnp.asarray(tb_b.reshape(nb_b, cb_eff))
                pb_b = jnp.asarray(pb_b.reshape(nb_b, cb_eff))
            else:
                nb_b, tb_b, pb_b = nb, tb, pb
            fn = jax.jit(
                lambda tb, pb, tiles=tiles, q_table=q_table: jax.lax.map(
                    lambda args: cross_section_tiles(
                        tiles, args[0], args[1], spec, nwidth=nwidth,
                        q_table=q_table, osamp=osamp, wndelt=wndelt,
                    ).astype(dtype),
                    (tb, pb),
                )
            )
            sig_b = np.asarray(fn(tb_b, pb_b))  # [nb_b, cb_eff, nt_b, W]
            sig_b = sig_b.reshape(nb_b * cb_eff, len(tile_idx), tile_size)
            for j, ti in enumerate(tile_idx):
                # accumulate: depth-split segments of one tile sum
                out[:ncond, ti * tile_size : (ti + 1) * tile_size] += (
                    sig_b[:ncond, j])
        sigma[im] = out[:ncond, :nW]

    return OpacityGrid(
        species=species,
        t_grid=t_grid,
        pressure=pressure_bar,
        wn_grid=np.asarray(wn_grid, np.float64),
        sigma=jnp.asarray(sigma.reshape(len(species), nT, nP, nW)),
    )


def interp_opacity(grid_sigma: jax.Array, t_grid_min: float, t_grid_step: float,
                   n_t: int, T_layers: jax.Array) -> jax.Array:
    """Runtime path (hot loop): interpolate sigma[mol, nT, nlayer, nwave]
    in T at per-layer temperatures -> sigma[mol, nlayer, nwave].

    Linear interpolation on the uniform T grid — the extinction.c
    equivalent step of run_transit (reference SURVEY.md 3.2).  Fully
    vectorized: one gather + lerp, jit/vmap-safe.
    """
    x = (T_layers - t_grid_min) / t_grid_step
    i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n_t - 2)
    f = jnp.clip(x - i0, 0.0, 1.0).astype(grid_sigma.dtype)
    nlayer = T_layers.shape[0]
    lay = jnp.arange(nlayer)
    # Lerp as a one-hot matmul over the T axis: under vmap (the chain
    # batch) the gather alternative re-reads two table slices per chain
    # from HBM, while the matmul streams the whole table ONCE per batch
    # as one contraction ([chain, layer, nT] x [mol, nT, layer, wn]).
    w = jnp.zeros((nlayer, n_t), grid_sigma.dtype)
    w = w.at[lay, i0].set(1.0 - f).at[lay, i0 + 1].add(f)
    return jnp.einsum("lt,mtlw->mlw", w, grid_sigma,
                      precision=jax.lax.Precision.HIGHEST)


def save_grid(grid: OpacityGrid, path: str) -> None:
    np.savez_compressed(
        path,
        species=np.asarray(grid.species),
        t_grid=grid.t_grid,
        pressure=grid.pressure,
        wn_grid=grid.wn_grid,
        sigma=np.asarray(grid.sigma),
    )


def load_grid(path: str) -> OpacityGrid:
    z = np.load(path)
    return OpacityGrid(
        species=[str(s) for s in z["species"]],
        t_grid=z["t_grid"],
        pressure=z["pressure"],
        wn_grid=z["wn_grid"],
        sigma=jnp.asarray(z["sigma"]),
    )
