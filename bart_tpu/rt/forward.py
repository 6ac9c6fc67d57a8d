"""The forward model: parameter vector -> band fluxes, as one pure JAX fn.

Accelerator-side inversion of the reference's process topology: where the
reference runs one MPI process per chain calling a C library per
proposal (reference: code/BARTfunc.py:309-399 hot loop), bart_tpu makes
the entire likelihood forward model a pure function

    bandflux, spectrum, valid = forward(params)

that is jit-compiled once and vmapped over all chains on-device.

Parameter layout (identical to the reference, code/BARTfunc.py:173-179):

    [ PT params (nPT) | radius (transit only) | cloudtop | scattering
      | log10 abundance factors (nmolfit) ]

Rejection semantics (reference scatters -1 sentinels; here a boolean
``valid`` that the sampler maps to loglike=-inf):

    * PT model non-physical                  (BARTfunc.py:319-323)
    * any T outside [Tmin, Tmax]             (BARTfunc.py:326-330)
    * scaled metal abundances sum > 1        (BARTfunc.py:339-344)
    * optional energy-balance veto e_out>e_in (BARTfunc.py:366-383)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from bart_tpu import constants as const
from bart_tpu.obs.bands import BandMatrix, band_integrate
from bart_tpu.opacity.cia import LOSCHMIDT, CiaTable
from bart_tpu.opacity.cloud import (
    cloud_deck_extinction, extended_cloud_extinction,
)
from bart_tpu.opacity.grid import OpacityGrid, interp_opacity
from bart_tpu.opacity.rayleigh import rayleigh_extinction
from bart_tpu.physics.hydro import anchor_index, radius_profile
from bart_tpu.physics.pt import n_pt_params, pt_generator
from bart_tpu.rt.eclipse import eclipse_flux, raygrid_weights
from bart_tpu.rt.tau import tau_vertical
from bart_tpu.rt.transit_geom import slant_geometry, transit_depth

__all__ = ["ForwardModel", "ForwardConfig"]


@dataclasses.dataclass(frozen=True)
class ForwardConfig:
    """Static configuration (fixed at trace time)."""

    solution: str = "eclipse"        # 'eclipse' | 'transit' | 'direct'
    pt_type: str = "line"
    molfit: tuple = ()               # species whose abundances are fitted
    tmin: float = 400.0              # reference Tmin (BARTfunc.py:67-72)
    tmax: float = 3000.0
    cloudtop: bool = False           # fit a cloud-deck top pressure
    cloudrad: tuple | None = None    # (r_top, r_bot) [km]: extended cloud
    cloudext: float = 0.0            # extinction at cloud bottom [cm-1]
    scattering: str | None = None    # None | 'ray' | 'polar'
    ebalance: bool = False
    refpress: float = 0.1            # p0 [bar] where R(p0)=Rp (demo cfg)
    raygrid: tuple = (0.0, 20.0, 40.0, 60.0, 80.0)
    # angular quadrature for the eclipse flux integral: 'raygrid'
    # (reference parity: trapezoid over the raygrid angles, 6e-3 error
    # vs the exact E3 integral) or 'expsum' (rt.eclipse.expsum_weights:
    # nquad exponential-sum nodes mu=1/m — 9e-5 error at nquad=8 AND
    # one-exponential attenuation in the fused kernels)
    quadrature: str = "raygrid"
    nquad: int = 8
    tint: float = 100.0
    tint_type: str = "const"

    @property
    def n_radfit(self) -> int:
        return int(self.solution == "transit")

    @property
    def n_cloud(self) -> int:
        return int(self.cloudtop)

    @property
    def n_ray(self) -> int:
        return int(self.scattering is not None)

    @property
    def n_pt(self) -> int:
        return n_pt_params[self.pt_type]

    @property
    def n_params(self) -> int:
        return (
            self.n_pt + self.n_radfit + self.n_cloud + self.n_ray + len(self.molfit)
        )


class ForwardModel:
    """Builds the jitted forward function from static tables.

    Equivalent of BARTfunc's initialization (reference
    code/BARTfunc.py:134-296) done once on host: species indexing,
    H2/He ratio, PT arguments, opacity table upload, band matrix.
    """

    def __init__(
        self,
        config: ForwardConfig,
        *,
        wn_grid: np.ndarray,
        pressure: np.ndarray,            # [bar], top-first ascending
        species: list[str],
        base_abundances: np.ndarray,     # [nlayer, nspecies]
        opacity: OpacityGrid,
        system,                          # io.tep.PlanetSystem
        bands: BandMatrix,
        cia_tables: list[CiaTable] = (),
        species_masses: np.ndarray | None = None,
        broadening=None,
        nwidth: float = 20.0,
        osamp: int = 1,
        fold_osamp: int = 1,
        fold_adapt: float | None = 0.02,
        fold_bf16: bool = False,
        dtype=jnp.float32,
    ):
        self.config = config
        self.system = system
        self.bands = bands
        self.dtype = dtype
        # on-the-fly bin-averaging factor (the wnosamp question;
        # docs/LINE_SAMPLING.md) and bin width for it
        self.osamp = int(osamp)
        # folded rtosamp (rt.fused folded kernels): ``wn_grid`` is the
        # OUTPUT grid; ``opacity`` is tabulated on the K-times-finer
        # folded_fine_grid and visited sub-sample-major by the folded
        # forms, which emit bin-averaged (after exp) output spectra.
        self.fold = int(fold_osamp)
        # bf16-stored fine tables (production knob, cfg `foldtable16`):
        # halves the K-times-fine table's device residency and upload;
        # each sub-sample slice is widened to f32 before its
        # contraction, so the error is the table's bf16 rounding alone.
        # Only the fine sigmak/frowsk tables are affected; the bin-mean
        # (smooth/diagnostic) tables and the K=1 path stay f32/HIGHEST.
        self.fold_bf16 = bool(fold_bf16) and self.fold > 1
        # static adaptive-resolution split (set in the fold branch)
        self._idx_fine = self._idx_smooth = None
        self.wndelt = float(wn_grid[1] - wn_grid[0]) if len(wn_grid) > 1 else 1.0
        cfg = config

        # All device arrays live in the `tables` pytree so they can be
        # passed as (shardable) jit arguments instead of baked closure
        # constants — required for multi-chip wavenumber sharding
        # (bart_tpu.parallel).
        t: dict[str, Any] = {}
        t["wn"] = jnp.asarray(wn_grid, dtype)
        t["pressure"] = jnp.asarray(pressure, dtype)
        t["p_barye"] = jnp.asarray(pressure * const.BAR_TO_BARYE, dtype)
        self.species = list(species)
        t["base_q"] = jnp.asarray(base_abundances, dtype)

        # --- species indexing (reference BARTfunc.py:189-201) ---
        sp = np.asarray(species)
        self.i_h2 = int(np.where(sp == "H2")[0][0])
        self.i_he = int(np.where(sp == "He")[0][0])
        self.i_metals = np.where(
            (sp != "He") & (sp != "H2") & (sp != "H-") & (sp != "e-")
        )[0]
        self.i_molfit = np.array(
            [int(np.where(sp == m)[0][0]) for m in cfg.molfit], int
        )
        # per-layer H2/He ratio (reference BARTfunc.py:193-194)
        t["h2he_ratio"] = jnp.asarray(
            base_abundances[:, self.i_h2] / base_abundances[:, self.i_he], dtype
        )

        if species_masses is None:
            from bart_tpu.linelist.molecules import get_molecule

            species_masses = np.array([get_molecule(s).mass for s in species])
        t["masses"] = jnp.asarray(species_masses, dtype)

        # --- opacity: precomputed grid OR on-the-fly line tiles ---
        # (the reference equally supports gridded and direct extinction;
        # SURVEY.md 2.2 "on-the-fly" mode, manual tex:776-778)
        if self.fold > 1 and isinstance(opacity, dict):
            raise ValueError(
                "folded rtosamp requires a precomputed opacity grid "
                "(the on-the-fly mode evaluates lines at arbitrary "
                "resolution already — use osamp there)")
        if isinstance(opacity, dict):
            # On-the-fly (table-free) mode: the line-tile arrays live in
            # the `tables` pytree so parallel.shard_model can shard the
            # TILE axis along the 'wn' mesh axis.  tile_lines already
            # duplicated every line whose wings reach a tile into that
            # tile's bucket, so the Voigt wing "halo" is materialized in
            # the bucketing and the sharded compute needs NO runtime
            # halo exchange (SURVEY.md 2.5 design note) — the only
            # collective left is the band-integration psum.
            self.opacity = None
            self.line_tiles = opacity          # {species: LineTiles}
            self._lt_meta = {}
            for k, (name, tiles) in enumerate(opacity.items()):
                self._lt_meta[name] = (k, float(tiles.cutoff))
                t[f"lt{k}_wn_tiles"] = tiles.wn_tiles
                t[f"lt{k}_grid_mask"] = tiles.grid_mask
                t[f"lt{k}_wn0"] = tiles.wn0
                t[f"lt{k}_s296"] = tiles.s296
                t[f"lt{k}_elower"] = tiles.elower
                t[f"lt{k}_gamma_air"] = tiles.gamma_air
                t[f"lt{k}_n_air"] = tiles.n_air
                t[f"lt{k}_weight"] = tiles.weight
            opac_species = list(opacity)
            self.broadening = broadening
            self.nwidth = nwidth
        else:
            self.opacity = opacity
            self.line_tiles = None
            self.t_min = float(opacity.t_grid[0])
            self.t_step = float(opacity.t_grid[1] - opacity.t_grid[0])
            self.n_t = len(opacity.t_grid)
            if self.fold > 1:
                from bart_tpu.opacity.grid import fine_bin_mask

                M, nT, nL_, Wf = opacity.sigma.shape
                Wout = len(wn_grid)
                if Wf != self.fold * Wout:
                    raise ValueError(
                        f"folded rtosamp={self.fold}: opacity grid has "
                        f"{Wf} wn samples but the output grid needs "
                        f"{self.fold} x {Wout}")
                # All folded-table prep runs on HOST numpy: holding the
                # K-times-fine table on device 3x at once (sig + the
                # fold_table transpose + sigbar) can exhaust memory for a
                # production K=32 multi-molecule grid before the
                # retrieval even starts; only the final hot-loop arrays
                # land on device.
                np_dt = np.dtype(jnp.dtype(dtype).name)
                sig = np.asarray(opacity.sigma).astype(np_dt, copy=False)
                sigbar = sig.reshape(M, nT, nL_, Wout, self.fold).mean(-1)
                # bin-averaged coarse table for the unfused/diagnostics
                # path (plots, contribution functions — NOT the chi^2
                # path, which runs the folded kernels)
                t["sigma"] = jnp.asarray(sigbar)
                # host-side fold_table (rt.fused.fold_table layout):
                # [M*nT, L, Wf] -> [K, M*nT, L, Wout] sub-sample-major
                sigk = np.transpose(
                    sig.reshape(M * nT, nL_, Wout, self.fold),
                    (3, 0, 1, 2))
                # static adaptive resolution (opacity.grid.fine_bin_mask):
                # only bins with in-bin line structure go through the
                # K-sub-sample kernel; smooth bins use the bin-mean
                # table at K=1 (error <= 0.27 delta^2, same 1e-4 class)
                self._idx_fine = self._idx_smooth = None
                if fold_adapt:
                    mask = fine_bin_mask(sig, self.fold,
                                         delta=float(fold_adapt))
                    if mask.any() and not mask.all():
                        self._idx_fine = np.where(mask)[0]
                        self._idx_smooth = np.where(~mask)[0]
                k_dt = jnp.bfloat16 if self.fold_bf16 else None
                if self._idx_fine is not None:
                    idx_f = self._idx_fine
                    idx_s = self._idx_smooth
                    t["sigmak"] = jnp.asarray(sigk[..., idx_f], k_dt)
                    t["sigmas"] = jnp.asarray(
                        sigbar.reshape(M * nT, nL_, Wout)[..., idx_s])
                    t["wn_f"] = jnp.asarray(wn_grid, dtype)[
                        jnp.asarray(idx_f)]
                    t["wn_s"] = jnp.asarray(wn_grid, dtype)[
                        jnp.asarray(idx_s)]
                else:
                    # sub-sample-major hot-loop layout [K, M*nT, L, Wout]
                    t["sigmak"] = jnp.asarray(sigk, k_dt)
            else:
                t["sigma"] = opacity.sigma.astype(dtype)
            opac_species = opacity.species
        self.i_opac = np.array(
            [int(np.where(sp == m)[0][0]) for m in opac_species], int
        )

        # --- CIA: resolve collider indices (reference cia.c) ---
        self.cia_idx = []
        for k, tab in enumerate(cia_tables):
            i1 = int(np.where(sp == tab.species[0])[0][0])
            i2 = int(np.where(sp == tab.species[1])[0][0])
            self.cia_idx.append((i1, i2))
            t[f"cia{k}_temps"] = jnp.asarray(tab.temps, dtype)
            t[f"cia{k}_wn"] = jnp.asarray(tab.wn, dtype)
            t[f"cia{k}_abs"] = jnp.asarray(tab.absorption, dtype)

        # --- geometry setup ---
        if cfg.quadrature == "expsum":
            from bart_tpu.rt.eclipse import expsum_weights

            mu, w = expsum_weights(cfg.nquad)
            self._powers = True
        elif cfg.quadrature == "raygrid":
            mu, w = raygrid_weights(cfg.raygrid)
            self._powers = False
        else:
            raise ValueError(
                f"quadrature must be 'raygrid' or 'expsum', "
                f"got {cfg.quadrature!r}")
        t["mu"] = jnp.asarray(mu, dtype)
        t["mu_w"] = jnp.asarray(w, dtype)
        t["band_w"] = bands.weights.astype(dtype)
        self.i0 = anchor_index(pressure, cfg.refpress)
        self.r0_km = system.r_planet / 1000.0
        self.g0_si = system.g_planet_si
        self._tables = t

        # PT extra args (reference BARTfunc.py:204-210)
        if cfg.pt_type == "line":
            self.pt_args = [
                system.r_star, system.t_star, cfg.tint, system.sma,
                system.g_planet_cgs, cfg.tint_type,
            ]
        else:
            self.pt_args = None

        # Fused-kernel eligibility (rt.fused): any gridded-opacity
        # eclipse/direct model.  Every continuum term is separable into
        # (per-layer weight) x (static wn row), so CIA, Rayleigh, and
        # gray clouds become extra rows of the same kernel contraction.
        self._fusable = self.opacity is not None
        if self._fusable:
            rows = []
            # folded mode: continuum rows are evaluated on the fine
            # grid too (a smooth row costs nothing extra there, and
            # it keeps the kernel contraction uniform)
            if self.fold > 1:
                from bart_tpu.utils.grids import folded_fine_grid

                wn_rows = folded_fine_grid(np.asarray(wn_grid), self.fold)
            else:
                wn_rows = np.asarray(wn_grid)
            nL, nW = len(pressure), len(wn_rows)
            self._cia_ntemps = []
            for tab in cia_tables:
                # hoist the wn interpolation of cia_extinction to setup
                # (the wn grid is static; T-weights stay runtime)
                wn_interp = np.stack([
                    np.interp(np.asarray(wn_rows, np.float64),
                              np.asarray(tab.wn, np.float64),
                              np.asarray(row, np.float64),
                              left=0.0, right=0.0)
                    for row in np.asarray(tab.absorption)
                ])
                rows.append(np.broadcast_to(
                    wn_interp[:, None, :], (len(tab.temps), nL, nW)))
                self._cia_ntemps.append(len(tab.temps))
            if cfg.scattering is not None:
                from bart_tpu.opacity.rayleigh import (
                    h2_rayleigh_cross_section,
                )

                sig_ray = np.asarray(
                    h2_rayleigh_cross_section(np.asarray(wn_rows))
                )
                rows.append(np.broadcast_to(
                    sig_ray[None, None, :], (1, nL, nW)))
            if cfg.cloudtop:
                rows.append(np.ones((1, nL, nW)))
            if cfg.cloudrad is not None and cfg.cloudext:
                rows.append(np.ones((1, nL, nW)))
            if rows:
                frows = jnp.asarray(np.concatenate(rows, axis=0), dtype)
                if self.fold > 1:
                    from bart_tpu.rt.fused import fold_table

                    frowsk = fold_table(frows, self.fold)
                    k_dt = jnp.bfloat16 if self.fold_bf16 else frows.dtype
                    if getattr(self, "_idx_fine", None) is not None:
                        # continuum rows are smooth by construction
                        # (CIA/Rayleigh/cloud vary over >> 1 bin), but
                        # their columns must follow the bin split
                        t["frowsk"] = frowsk[
                            ..., jnp.asarray(self._idx_fine)].astype(k_dt)
                        t["frowss"] = jnp.mean(frowsk, axis=0)[
                            ..., jnp.asarray(self._idx_smooth)]
                    else:
                        t["frowsk"] = frowsk.astype(k_dt)
                else:
                    t["frows"] = frows

        self._jitted = None

    # -----------------------------------------------------------------
    @property
    def tables(self) -> dict:
        """The device-array pytree (pass through jit args to shard)."""
        return self._tables

    def __call__(self, params: jax.Array, tables: dict | None = None):
        """forward(params[n_params]) -> (bandflux[nfilt], spectrum[nwave],
        valid[bool]).  Pure function of (params, tables);
        jit/vmap/grad-safe.  ``tables`` defaults to the model's own
        arrays; pass them explicitly (e.g. device_put with shardings)
        for multi-chip execution."""
        t = self._tables if tables is None else tables
        cfg = self.config
        nPT = cfg.n_pt
        dtype = self.dtype
        if params.shape[-1] != cfg.n_params:
            raise ValueError(
                f"params has {params.shape[-1]} entries; config "
                f"{cfg.solution}/{cfg.pt_type} with molfit={cfg.molfit} "
                f"expects {cfg.n_params}"
            )
        params = params.astype(dtype)
        T_safe, q, rad_cm, valid = self._profiles(params, t)
        spectrum = self._spectrum(params, t, T_safe, q, rad_cm)
        wn = t["wn"]

        # 6. optional energy-balance veto (BARTfunc.py:366-383)
        if cfg.ebalance and cfg.solution in ("eclipse", "direct"):
            sysm = self.system
            e_in = (
                const.SIGMA_SB * sysm.t_star**4 * sysm.r_star**2
                * np.pi * sysm.r_planet**2 / sysm.sma**2 * const.JOULE_TO_ERG
            )
            e_out = jnp.trapezoid(spectrum, wn) * 4.0 * (
                sysm.r_planet * 100.0
            ) ** 2
            valid &= e_out <= e_in

        # 7. band integration (BARTfunc.py:385-396; star division folded
        #    into the band matrix for eclipse)
        bandflux = band_integrate(t["band_w"], spectrum)
        return bandflux, spectrum, valid

    def spectrum_from_profiles(self, T, q, rad_cm=None):
        """Spectrum directly from explicit atmosphere profiles — the
        standalone-transit semantics (reference: `transit -c cfg`
        computes one spectrum from the atm file's own T/q columns,
        SURVEY.md 2.2), bypassing the PT/abundance parametrization.

        T [nlayer] K; q [nlayer, nspecies] mole fractions; rad_cm
        optional explicit radius column (hydrostatic re-derivation
        from T/q when omitted, like makeatm.radpress).
        """
        t = self._tables
        dtype = self.dtype
        T_safe = jnp.clip(jnp.asarray(T, dtype), self.config.tmin,
                          self.config.tmax)
        q = jnp.asarray(q, dtype)
        if rad_cm is None:
            mmm = jnp.matmul(q, t["masses"],
                             precision=jax.lax.Precision.HIGHEST)
            rad_km = radius_profile(
                t["pressure"], T_safe, mmm, self.config.refpress,
                jnp.asarray(self.r0_km, dtype), self.g0_si, i0=self.i0,
            )
            rad_cm = rad_km * const.KM_TO_CM
        else:
            rad_cm = jnp.asarray(rad_cm, dtype)
        params = jnp.zeros(self.config.n_params, dtype)
        return self._spectrum(params, t, T_safe, q, rad_cm)

    def _spectrum(self, params, t, T_safe, q, rad_cm):
        """Steps 4+5: extinction -> geometry -> spectrum (run_transit
        equivalent, BARTfunc.py:363).  Every gridded-opacity model —
        eclipse AND transit geometry, with CIA/Rayleigh/clouds folded
        in as extra contraction rows — runs through rt.fused (eclipse
        K=1 as one fused kernel on the GPU).  Only the on-the-fly
        (table-free) line path uses the composable unfused ops."""
        cfg = self.config
        wn = t["wn"]
        if self._fusable and cfg.solution in ("eclipse", "direct"):
            parts, wrows = self._fused_rows(params, t, T_safe, q, rad_cm)
            dr = rad_cm[:-1] - rad_cm[1:]
            drp = jnp.concatenate([jnp.zeros_like(dr[:1]), dr])
            from bart_tpu.rt.fused import fused_eclipse, fused_eclipse_folded

            pieces = []
            for tab, folded, wn_p, idx in parts:
                fn = fused_eclipse_folded if folded else fused_eclipse
                pieces.append((fn(
                    tab, wn_p, t["mu"], t["mu_w"], wrows, T_safe, drp,
                    powers=self._powers,
                ), idx))
            spectrum = self._assemble(pieces, wn.shape[0])
        elif cfg.solution in ("eclipse", "direct"):
            ext = self._extinction(params, t, T_safe, q, rad_cm)
            tau = tau_vertical(ext, rad_cm)
            spectrum = eclipse_flux(tau, T_safe, wn, t["mu"], t["mu_w"])
        elif cfg.solution == "transit" and self._fusable:
            parts, wrows = self._fused_rows(params, t, T_safe, q, rad_cm)
            G, wgt = slant_geometry(rad_cm)
            from bart_tpu.rt.fused import fused_transit, fused_transit_folded

            pieces = []
            for tab, folded, wn_p, idx in parts:
                fn = fused_transit_folded if folded else fused_transit
                pieces.append((fn(tab, wrows, G, wgt), idx))
            absorbed = self._assemble(pieces, wn.shape[0])
            spectrum = (rad_cm[-1] ** 2 + absorbed) / (
                self.system.r_star * 100.0
            ) ** 2
        elif cfg.solution == "transit":
            ext = self._extinction(params, t, T_safe, q, rad_cm)
            spectrum = transit_depth(ext, rad_cm, self.system.r_star * 100.0)
        else:
            raise ValueError(f"unknown solution {cfg.solution!r}")
        return spectrum

    @staticmethod
    def _assemble(pieces, n_wn):
        """Reassemble the output spectrum from adaptive dispatch parts
        ((values, scatter_indices or None) pairs; a single None-index
        piece IS the spectrum)."""
        if len(pieces) == 1 and pieces[0][1] is None:
            return pieces[0][0]
        out = jnp.zeros(n_wn, pieces[0][0].dtype)
        for vals, idx in pieces:
            out = out.at[jnp.asarray(idx)].set(vals)
        return out

    def _atmosphere(self, params, t):
        """Steps 1-4 of the hot loop: params -> (T, q, radii, extinction,
        valid).  Used by diagnostics() (which needs the extinction
        explicitly; __call__ may take the fused path instead)."""
        T_safe, q, rad_cm, valid = self._profiles(params, t)
        ext = self._extinction(params, t, T_safe, q, rad_cm)
        return T_safe, q, rad_cm, ext, valid

    def _profiles(self, params, t):
        """Steps 1-3: params -> (T, q, radius, valid)."""
        cfg = self.config
        nPT = cfg.n_pt
        dtype = self.dtype
        pressure = t["pressure"]

        # 1. temperature profile (BARTfunc.py:320-330)
        T, pt_valid = pt_generator(
            pressure, params[:nPT], cfg.pt_type, self.pt_args
        )
        T = T.astype(dtype)
        valid = pt_valid & jnp.all((T >= cfg.tmin) & (T <= cfg.tmax))
        T_safe = jnp.clip(T, cfg.tmin, cfg.tmax)

        # 2. abundance scaling + H2/He renormalization (BARTfunc.py:332-347)
        base_q = t["base_q"]
        q = base_q
        off = nPT + cfg.n_radfit + cfg.n_cloud + cfg.n_ray
        for k, im in enumerate(self.i_molfit):
            q = q.at[:, im].set(base_q[:, im] * 10.0 ** params[off + k])
        metals = jnp.sum(q[:, self.i_metals], axis=1)
        qfree = 1.0 - metals
        valid &= jnp.all(qfree >= 0.0)
        qfree_safe = jnp.maximum(qfree, 0.0)
        r = t["h2he_ratio"]
        q = q.at[:, self.i_h2].set(r * qfree_safe / (1.0 + r))
        q = q.at[:, self.i_he].set(qfree_safe / (1.0 + r))

        # 3. hydrostatic radii (reference precomputes in the atm file;
        #    bart_tpu re-derives per sample so T feedback is exact)
        mmm = jnp.matmul(q, t["masses"],
                         precision=jax.lax.Precision.HIGHEST)
        if cfg.n_radfit:
            r0 = params[nPT]  # fitted radius [km] (set_radius, BARTfunc.py:351)
        else:
            r0 = jnp.asarray(self.r0_km, dtype)
        rad_km = radius_profile(
            pressure, T_safe, mmm, cfg.refpress, r0, self.g0_si, i0=self.i0
        )
        rad_cm = rad_km * const.KM_TO_CM
        return T_safe, q, rad_cm, valid

    def _fused_rows(self, params, t, T_safe, q, rad_cm):
        """(tab [R, L, wn], wrows [L, R]) for rt.fused.fused_eclipse —
        the whole extinction as one rows-contraction.  Weight formulas
        mirror _extinction term by term (same clamping/bracketing)."""
        cfg = self.config
        nPT = cfg.n_pt
        sigma = t["sigma"]
        M, nT, L, W = sigma.shape
        from bart_tpu.rt.fused import interp_weights

        n_tot = t["p_barye"] / (const.K_BOLTZ * T_safe)          # [cm-3]
        n_mol = q[:, self.i_opac] * n_tot[:, None]               # [L, mol]
        w_t = interp_weights(self.n_t, self.t_min, self.t_step, T_safe)
        cols = [(n_mol[:, :, None] * w_t[:, None, :]).reshape(L, M * nT)]

        for k, (i1, i2) in enumerate(self.cia_idx):
            from bart_tpu.opacity.cia import LOSCHMIDT

            temps = t[f"cia{k}_temps"]
            nTc = self._cia_ntemps[k]
            it = jnp.clip(jnp.searchsorted(temps, T_safe) - 1, 0, nTc - 2)
            f = jnp.clip(
                (T_safe - temps[it]) / (temps[it + 1] - temps[it]), 0.0, 1.0
            )
            iota = jnp.arange(nTc)
            w_c = jnp.where(iota == it[:, None], 1.0 - f[:, None], 0.0)
            w_c = jnp.where(iota == it[:, None] + 1, w_c + f[:, None], w_c)
            n1n2 = (q[:, i1] * n_tot / LOSCHMIDT) * (
                q[:, i2] * n_tot / LOSCHMIDT
            )
            cols.append(w_c * n1n2[:, None])

        if cfg.scattering is not None:
            if cfg.scattering == "polar":                 # mode 2, unscaled
                factor = jnp.asarray(1.0, T_safe.dtype)
            else:                                         # mode 1: 10^param
                ray_par = params[nPT + cfg.n_radfit + cfg.n_cloud]
                factor = 10.0 ** ray_par
            cols.append((factor * q[:, self.i_h2] * n_tot)[:, None])

        if cfg.cloudtop:
            ctop = params[nPT + cfg.n_radfit]
            prof = cloud_deck_extinction(
                t["pressure"], jnp.log10(jnp.maximum(ctop, 1e-30)), 1
            )
            cols.append(prof[:, 0:1])

        if cfg.cloudrad is not None and cfg.cloudext:
            prof = extended_cloud_extinction(
                rad_cm / const.KM_TO_CM, cfg.cloudrad[0], cfg.cloudrad[1],
                cfg.cloudext,
            )
            cols.append(prof[:, None])

        wrows = jnp.concatenate(cols, axis=1)
        if self.fold > 1:
            # dispatch parts: (tab, folded?, wn array, scatter indices)
            parts = []
            if "sigmak" in t:
                tab = t["sigmak"]                   # [K, M*nT, L, W_f]
                if "frowsk" in t:
                    tab = jnp.concatenate([tab, t["frowsk"]], axis=1)
                wn_p = t["wn_f"] if self._idx_fine is not None else t["wn"]
                parts.append((tab, True, wn_p, self._idx_fine))
            if "sigmas" in t:
                tab = t["sigmas"]                   # [M*nT, L, W_s]
                if "frowss" in t:
                    tab = jnp.concatenate([tab, t["frowss"]], axis=0)
                parts.append((tab, False, t["wn_s"], self._idx_smooth))
            return parts, wrows
        tab = sigma.reshape(M * nT, L, W)
        if "frows" in t:
            tab = jnp.concatenate([tab, t["frows"]], axis=0)
        return [(tab, False, t["wn"], None)], wrows

    def _extinction(self, params, t, T_safe, q, rad_cm):
        """Step 4: extinction [cm-1] per (layer, wn) — unfused path."""
        cfg = self.config
        nPT = cfg.n_pt
        dtype = self.dtype
        pressure = t["pressure"]
        wn = t["wn"]
        rad_km = rad_cm / const.KM_TO_CM
        n_tot = t["p_barye"] / (const.K_BOLTZ * T_safe)          # [cm-3]
        if self.line_tiles is not None:
            # on-the-fly line-by-line path (no opacity grid; the
            # reference's non-gridded extinction mode).  Tiles are
            # rebuilt from the tables pytree so sharded tile arrays
            # flow through (parallel.shard_model).
            from bart_tpu.opacity.extinction import (
                BroadeningSpec, LineTiles, cross_section_grid,
            )

            bspec = self.broadening or BroadeningSpec()
            n_grid = int(wn.shape[0])
            sigs = []
            for name, (k, cutoff) in self._lt_meta.items():
                tiles = LineTiles(
                    species=name,
                    wn_tiles=t[f"lt{k}_wn_tiles"],
                    grid_mask=t[f"lt{k}_grid_mask"],
                    wn0=t[f"lt{k}_wn0"],
                    s296=t[f"lt{k}_s296"],
                    elower=t[f"lt{k}_elower"],
                    gamma_air=t[f"lt{k}_gamma_air"],
                    n_air=t[f"lt{k}_n_air"],
                    weight=t[f"lt{k}_weight"],
                    cutoff=cutoff,
                    n_grid=n_grid,
                )
                sigs.append(
                    cross_section_grid(
                        tiles, T_safe, t["p_barye"], bspec,
                        nwidth=self.nwidth, osamp=self.osamp,
                        wndelt=self.wndelt,
                    ).astype(dtype)
                )
            sigma = jnp.stack(sigs)                              # [mol, L, wn]
        else:
            sigma = interp_opacity(
                t["sigma"], self.t_min, self.t_step, self.n_t, T_safe,
            )                                                    # [mol, L, wn]
        n_mol = (q[:, self.i_opac] * n_tot[:, None]).T           # [mol, L]
        ext = jnp.einsum("mlw,ml->lw", sigma, n_mol,
                         precision=jax.lax.Precision.HIGHEST)

        for k, (i1, i2) in enumerate(self.cia_idx):
            from bart_tpu.opacity.cia import cia_extinction

            n1 = q[:, i1] * n_tot / LOSCHMIDT
            n2 = q[:, i2] * n_tot / LOSCHMIDT
            ext = ext + cia_extinction(
                t[f"cia{k}_temps"], t[f"cia{k}_wn"], t[f"cia{k}_abs"],
                wn, T_safe, n1, n2,
            )

        if cfg.scattering is not None:
            if cfg.scattering == "polar":   # set_scattering(2, 0)
                ext = ext + rayleigh_extinction(
                    wn, q[:, self.i_h2] * n_tot, 0.0, mode=2
                )
            else:                            # set_scattering(1, param)
                ray_par = params[nPT + cfg.n_radfit + cfg.n_cloud]
                ext = ext + rayleigh_extinction(
                    wn, q[:, self.i_h2] * n_tot, ray_par, mode=1
                )

        if cfg.cloudtop:
            ctop = params[nPT + cfg.n_radfit]  # cloud-top pressure [bar]
            ext = ext + cloud_deck_extinction(
                pressure, jnp.log10(jnp.maximum(ctop, 1e-30)), wn.shape[0]
            )

        if cfg.cloudrad is not None and cfg.cloudext:
            # static extended gray cloud (transit cloudrad/cloudext)
            prof = extended_cloud_extinction(
                rad_km, cfg.cloudrad[0], cfg.cloudrad[1], cfg.cloudext
            )
            ext = ext + prof[:, None]

        return ext

    def diagnostics(self, params: jax.Array):
        """Atmospheric-structure intermediates for post-processing
        (contribution functions, transmittance, PT envelopes):
        (T[K], q[layer,spec], radius[cm], extinction[layer,wn], valid).
        The reference obtains these by re-running the transit binary
        with savefiles (code/cf.py:37-94); here they fall out of the
        forward model directly."""
        t = self._tables
        return self._atmosphere(params.astype(self.dtype), t)

    def diagnostics_batch(self):
        """Jitted, vmapped diagnostics over a parameter batch
        (posterior PT-envelope sampling)."""
        if getattr(self, "_diag_batch", None) is None:
            self._diag_batch = jax.jit(jax.vmap(self.diagnostics))
        return self._diag_batch

    # convenience views used by tests/tools
    @property
    def wn(self):
        return self._tables["wn"]

    @property
    def pressure(self):
        return self._tables["pressure"]

    @property
    def sigma(self):
        return self._tables["sigma"]

    @property
    def mu(self):
        return self._tables["mu"]

    @property
    def mu_w(self):
        return self._tables["mu_w"]

    # -----------------------------------------------------------------
    def jitted(self):
        """Single-sample jitted forward.  Tables are passed as jit
        ARGUMENTS (not closure constants) so committed shardings reach
        XLA's partitioner — see Likelihood.tables."""
        if self._jitted is None:
            fn = jax.jit(self.__call__)
            self._jitted = lambda p: fn(p, self._tables)
        return self._jitted

    def batched(self):
        """vmapped forward over a chain batch: params[nchain, n_params]."""
        fn = jax.jit(jax.vmap(self.__call__, in_axes=(0, None)))
        return lambda batch: fn(batch, self._tables)
