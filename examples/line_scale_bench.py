"""Realistic line-count scaling study (HITEMP-class list sizes).

The reference's WASP-12b regression implies 1e5-1e6 HITEMP lines with
ethresh 1e-99 and nwidth 60 (reference: examples/WASP-12b/BART.cfg;
BASELINE.md row 9).  This script measures, at 300k / 1M / 3M synthetic
lines with HITEMP-like band-head density skew over the WASP-12b
wavenumber range:

* tile-padding inflation: uniform max-depth tiling vs the
  variable-depth geometric buckets (opacity.extinction.
  tile_lines_bucketed) used by build_opacity_grid;
* opacity-table build time (the --justOpacity stage) on the current
  backend;
* the gridded hot-loop eval rate (table-based, hence line-count
  independent — reported once for context);
* an on-the-fly (table-free) single-eval timing at 300k lines.

Usage:  python examples/line_scale_bench.py [nlines ...]
The padding results are summarized in docs/LINE_SAMPLING.md.
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from bart_tpu.linelist.hitran import LineList
from bart_tpu.opacity.extinction import (
    BroadeningSpec, tile_lines, tile_lines_bucketed,
)
from bart_tpu.opacity.grid import build_opacity_grid

WN_LO, WN_HI = 910.0, 3400.0        # WASP-12b range (BART.cfg)
BANDS = (1150.0, 1600.0, 2300.0, 3100.0)


def skewed_linelist(n, seed=1, tight=10.0):
    """HITEMP-like density skew: 90% of lines in band heads (Gaussian
    clusters), 10% background."""
    rng = np.random.default_rng(seed)
    nb = int(0.9 * n) // len(BANDS)
    nu = np.concatenate(
        [rng.normal(c, tight, nb) for c in BANDS]
        + [rng.uniform(WN_LO - 10, WN_HI + 10, n - nb * len(BANDS))]
    )
    nu = np.sort(np.clip(nu, WN_LO - 10, WN_HI + 10))
    m = len(nu)
    return LineList(
        "H2O", nu, 1e-19 * 10 ** rng.uniform(-8, 0, m),
        rng.uniform(0, 3000, m), rng.uniform(0.03, 0.08, m),
        rng.uniform(0.05, 0.12, m), rng.uniform(0.4, 0.8, m),
        np.ones(m, np.int8),
    )


def main(argv):
    sizes = [int(float(a)) for a in argv[1:]] or [300_000, 1_000_000,
                                                  3_000_000]
    wn = WN_LO + 1.0 * np.arange(int(WN_HI - WN_LO) + 1)
    pressure = np.logspace(-5, 2, 100)
    t_grid = np.arange(400.0, 3001.0, 100.0)
    spec = BroadeningSpec()
    print(f"# backend={jax.default_backend()}  grid={len(wn)} wn x "
          f"{len(pressure)} layers x {len(t_grid)} T  nwidth=60")

    rows = []
    for n in sizes:
        ll = skewed_linelist(n)
        uni = tile_lines(ll, wn, 25.0, tile_size=256)
        buckets = tile_lines_bucketed(ll, wn, 25.0, tile_size=256)
        slots_u = uni.wn0.shape[0] * uni.wn0.shape[1]
        slots_b = sum(t.wn0.shape[0] * t.wn0.shape[1] for _, t in buckets)
        real = float(np.asarray(uni.weight).sum())
        del uni

        t0 = time.time()
        grid = build_opacity_grid(
            {"H2O": ll}, wn, t_grid, pressure, spec=spec, nwidth=60.0,
            cond_batch=32,
        )
        jax.block_until_ready(grid.sigma)
        t_build = time.time() - t0
        # steady-state: second build re-uses the compiled programs
        t0 = time.time()
        grid = build_opacity_grid(
            {"H2O": ll}, wn, t_grid, pressure, spec=spec, nwidth=60.0,
            cond_batch=32,
        )
        jax.block_until_ready(grid.sigma)
        t_build2 = time.time() - t0
        # Voigt points actually evaluated = slots_b x tile_size x nconds
        vpts = slots_b * 256 * (len(pressure) * len(t_grid))
        rows.append(dict(
            nlines=n, real_slots=int(real), uniform_slots=int(slots_u),
            bucket_slots=int(slots_b),
            inflation_uniform=round(slots_u / real, 2),
            inflation_buckets=round(slots_b / real, 2),
            build_s=round(t_build, 1), build_steady_s=round(t_build2, 1),
            voigt_pts_per_s=float(f"{vpts / t_build2:.3g}"),
        ))
        print("# " + json.dumps(rows[-1]))
        del grid

    # on-the-fly single-eval timing (fixed at 300k: the table-free
    # mode uses UNIFORM tiling whose 3M-line program exceeds what one
    # dispatch should hold — at that scale the table is the only
    # sensible object, which is the measurement's conclusion anyway)
    n_fly = min(min(sizes), 300_000)
    ll = skewed_linelist(n_fly)
    from bart_tpu.opacity.extinction import cross_section_grid

    tiles = tile_lines(ll, wn, 25.0, tile_size=256)
    T = jnp.asarray(np.linspace(900.0, 2900.0, len(pressure)))
    p = jnp.asarray(pressure * 1e6)
    f = jax.jit(lambda T, p: cross_section_grid(tiles, T, p, spec,
                                                nwidth=60.0))
    jax.block_until_ready(f(T, p))
    t0 = time.time()
    jax.block_until_ready(f(T, p))
    t_fly = time.time() - t0
    print(f"# on-the-fly sigma[100 layers x {len(wn)} wn] at "
          f"{n_fly} lines: {t_fly*1e3:.0f} ms per profile "
          f"(table-free mode; the reference's is 'a couple of minutes' "
          f"per run, manual tex:776-778)")
    print(json.dumps(dict(metric="line_scale", rows=rows,
                          onthefly_ms_300k=round(t_fly * 1e3, 1))))


if __name__ == "__main__":
    main(sys.argv)
