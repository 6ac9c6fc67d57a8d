"""Line-core sampling convergence study (the `wnosamp` question).

The reference oversamples its wavenumber grid x2160 (wnosamp,
examples/demo/BART_eclipse.cfg) because Doppler cores (~1e-2 cm-1) are
far narrower than the 1.0 cm-1 output spacing; its Voigt profiles are
tabulated on the fine grid and line centers snap to it, but tau/flux
are still evaluated at the output samples — i.e. the reference
POINT-SAMPLES the spectrum at output wavenumbers with centers quantized
to the fine grid.  bart_tpu's osamp=1 mode is the same physics with
EXACT (unquantized) centers; osamp>1 bin-averages the cross-section
over each output bin (midpoint rule, opacity/extinction.py).

This script measures, for both geometries, the band-flux error of

  * point sampling (osamp=1, the reference-equivalent mode),
  * bin-averaged cross-sections (osamp = 2..32), and
  * the gridded-opacity path (table built with osamp 1 vs 16)

against a brute-force physical truth: the full RT pipeline run on a
fine grid of ``--fine`` points per output bin (default 256, i.e. the
spectrum and the band integrals are computed at Delta = 1/256 cm-1,
resolving every Doppler core), plus a half-resolution truth to confirm
the truth itself converged.

Run on CPU in float64:

  JAX_PLATFORMS=cpu python examples/line_sampling_study.py

Results are written to docs/line_sampling_results.json and summarized
in docs/LINE_SAMPLING.md.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from bart_tpu import constants as const  # noqa: E402
from bart_tpu.io.kurucz import blackbody_star  # noqa: E402
from bart_tpu.io.tep import PlanetSystem  # noqa: E402
from bart_tpu.linelist.molecules import get_molecule  # noqa: E402
from bart_tpu.linelist.tli import synthetic_linelist  # noqa: E402
from bart_tpu.obs.bands import band_integrate, build_band_matrix  # noqa: E402
from bart_tpu.opacity.extinction import (  # noqa: E402
    BroadeningSpec, tile_lines, wing_cutoff,
)
from bart_tpu.opacity.grid import build_opacity_grid  # noqa: E402
from bart_tpu.rt.forward import ForwardConfig, ForwardModel  # noqa: E402
from bart_tpu.utils.grids import pressure_grid  # noqa: E402

# assumed demo system (examples/make_demo_inputs.py)
DEMO_TEP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "demo_inputs", "demo_system.tep")
NWIDTH = 20.0  # demo cfg nwidth (examples/demo/BART_eclipse.cfg)


def gaussian_filters(lo, hi, n=3, width=22.0):
    """Smooth synthetic filters well inside [lo, hi] (demo-like widths)."""
    centers = np.linspace(lo + 75.0, hi - 75.0, n)
    out = []
    for c in centers:
        fw = np.linspace(c - 3 * width, c + 3 * width, 241)
        out.append((fw, np.exp(-0.5 * ((fw - c) / width) ** 2)))
    return out


def make_setup(args):
    system = PlanetSystem.from_tep(DEMO_TEP)
    pressure = pressure_grid(args.layers, 1e-5, 100.0)
    species = ["H2", "He", "CH4"]
    base_q = np.tile([0.85, 0.149, 1e-3], (args.layers, 1))
    lines = synthetic_linelist(
        "CH4", args.wn_lo, args.wn_hi, args.nlines, seed=7,
        band_centers=(args.wn_lo + 90.0, args.wn_lo + 210.0),
    )
    mol = get_molecule("CH4")
    bspec = BroadeningSpec()
    cutoff = wing_cutoff(
        NWIDTH, args.wn_hi, 400.0, 100.0 * const.BAR_TO_BARYE,
        mol.mass * const.AMU, mol.diameter * 1e-8, bspec,
    )
    filters = gaussian_filters(args.wn_lo, args.wn_hi)
    return system, pressure, species, base_q, lines, bspec, cutoff, filters


def make_model(wn, solution, filters, setup, osamp=1, opacity=None,
               dummy_bands=False):
    system, pressure, species, base_q, lines, bspec, cutoff, _ = setup
    if opacity is None:
        tiles = {"CH4": tile_lines(lines, wn, cutoff, tile_size=256)}
        opacity = tiles
    if dummy_bands:
        fw = np.linspace(wn[2], wn[-3], 64)
        filters = [(fw, np.ones_like(fw))]
    if solution == "eclipse":
        starfl, _ = blackbody_star(wn, system.t_star)
        bands = build_band_matrix(wn, filters, star_flux=starfl,
                                  rprs=system.rprs)
    else:
        bands = build_band_matrix(wn, filters)
    config = ForwardConfig(solution=solution, pt_type="line", molfit=("CH4",))
    return ForwardModel(
        config, wn_grid=wn, pressure=pressure, species=species,
        base_abundances=base_q, opacity=opacity, system=system, bands=bands,
        broadening=bspec, nwidth=NWIDTH, osamp=osamp, dtype=jnp.float64,
    )


def truth_bands(factor, solution, params, setup, filters, args, chunk=12000):
    """Brute-force truth: full RT at Delta/factor, band-integrated on
    the fine grid."""
    system = setup[0]
    nfine = (args.wn_hi - args.wn_lo) * factor + 1
    wn_fine = args.wn_lo + np.arange(nfine) / factor
    specs = []
    nchunks = max(1, int(np.ceil(len(wn_fine) / chunk)))
    for wn_c in np.array_split(wn_fine, nchunks):
        fm = make_model(wn_c, solution, None, setup, osamp=1,
                        dummy_bands=True)
        _, spec, valid = fm.jitted()(jnp.asarray(params))
        assert bool(valid)
        specs.append(np.asarray(spec))
    spectrum = np.concatenate(specs)
    if solution == "eclipse":
        starfl, _ = blackbody_star(wn_fine, system.t_star)
        bm = build_band_matrix(wn_fine, filters, star_flux=starfl,
                               rprs=system.rprs)
    else:
        bm = build_band_matrix(wn_fine, filters)
    return np.asarray(band_integrate(bm, jnp.asarray(spectrum)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--wn-lo", type=float, default=2500.0)
    ap.add_argument("--wn-hi", type=float, default=2800.0)
    ap.add_argument("--nlines", type=int, default=1200)
    ap.add_argument("--layers", type=int, default=40)
    ap.add_argument("--fine", type=int, default=256)
    ap.add_argument("--osamps", type=int, nargs="+", default=[8, 16])
    args = ap.parse_args()

    setup = make_setup(args)
    filters = setup[-1]
    wn = np.arange(args.wn_lo, args.wn_hi + 0.5, 1.0)
    results = {"config": vars(args)}

    for solution in ("eclipse", "transit"):
        params = np.array([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5])
        if solution == "transit":
            r0 = setup[0].r_planet / 1000.0
            params = np.concatenate([params[:5], [r0], params[5:]])

        t0 = time.time()
        truth = truth_bands(args.fine, solution, params, setup, filters, args)
        print(f"[{solution}] truth x{args.fine} computed ({time.time()-t0:.0f}s)")

        # spectrum-level RT oversampling: full RT on a xK grid, bands
        # integrated on the fine grid (the production `rtosamp` knob)
        rt_rows = {}
        k = 1
        while k < args.fine:
            bf = truth_bands(k, solution, params, setup, filters, args)
            err = float(np.max(np.abs(bf / truth - 1.0)))
            rt_rows[k] = err
            print(f"[{solution}] RT x{k:3d}: max band-flux rel err {err:.3e}")
            k *= 2

        # sigma-bin-averaged mode (arctan-quadrature osamp): quantifies
        # the curve-of-growth bias of averaging sigma before exp(-tau)
        rows = {}
        for osamp in args.osamps:
            fm = make_model(wn, solution, filters, setup, osamp=osamp)
            bf, _, valid = fm.jitted()(jnp.asarray(params))
            assert bool(valid)
            err = float(np.max(np.abs(np.asarray(bf) / truth - 1.0)))
            rows[osamp] = err
            print(f"[{solution}] sigma-avg osamp={osamp:3d}: max band-flux "
                  f"rel err {err:.3e}")

        grid_rows = {}
        for osamp in (1, 16):
            grid = build_opacity_grid(
                {"CH4": setup[4]}, wn, np.arange(400.0, 3001.0, 50.0),
                setup[1], spec=setup[5], nwidth=NWIDTH, cond_batch=40,
                dtype=jnp.float64, osamp=osamp,
            )
            fm = make_model(wn, solution, filters, setup, opacity=grid)
            bf, _, valid = fm.jitted()(jnp.asarray(params))
            assert bool(valid)
            err = float(np.max(np.abs(np.asarray(bf) / truth - 1.0)))
            grid_rows[osamp] = err
            print(f"[{solution}] gridded osamp={osamp:3d}: max band-flux "
                  f"rel err {err:.3e}")

        results[solution] = {
            "truth_self_convergence": rt_rows[args.fine // 2],
            "rt_oversample": rt_rows,
            "sigma_bin_averaged": rows,
            "gridded": grid_rows,
            "truth_bands": truth.tolist(),
        }

    out = os.path.join(REPO, "docs", "line_sampling_results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
