"""Folded+adaptive rtosamp at HITEMP line density (round-4 study).

The adaptive-fold speedup rests on the fraction of output bins that
are line-free ("smooth", run at K=1 on bin-mean tables).  That
fraction was measured at demo density (30k lines: 43-57%% smooth);
this script measures it at HITEMP-class density (300k / 1M / 3M
lines with band-head skew over the WASP-12b range, nwidth=60,
ethresh=1e-99 semantics) and then measures the folded-kernel
throughput AT each measured fraction, so the scaling carries measured
numbers instead of an extrapolation from demo density
(docs/LINE_SAMPLING.md records the fractions).

Method:
1. fine-bin fraction: build the K-times-fine cross-section table on a
   SUBSAMPLED condition set (5 T-nodes x 10 layers instead of
   27 x 100) and apply opacity.grid.fine_bin_mask.  The mask is a max
   over conditions, so the subsample UNDERestimates the fraction
   slightly; the 30k-line case is run at both full and subsampled
   conds to report that bias.
2. throughput at fraction f: time the folded eclipse/transit kernels
   on synthetic tables with round(f * W) fine bins (kernel cost
   depends on the split sizes, not the table values).

Usage: python examples/fold_density_study.py [nlines ...]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from bart_tpu.opacity.grid import build_opacity_grid, fine_bin_mask
from bart_tpu.opacity.extinction import BroadeningSpec
from line_scale_bench import WN_LO, WN_HI, skewed_linelist

K = 32
NLAYER_SUB, NT_SUB = 10, 5


def fine_fraction(nlines, wn_out, full_conds=False):
    from bart_tpu.utils.grids import folded_fine_grid

    ll = skewed_linelist(nlines)
    wn_fine = folded_fine_grid(wn_out, K)
    if full_conds:
        pressure = np.logspace(-5, 2, 100)
        t_grid = np.arange(400.0, 3001.0, 100.0)
    else:
        pressure = np.logspace(-5, 2, NLAYER_SUB)
        t_grid = np.linspace(400.0, 3000.0, NT_SUB)
    t0 = time.time()
    grid = build_opacity_grid({"H2O": ll}, wn_fine, t_grid, pressure,
                              spec=BroadeningSpec(), nwidth=60.0,
                              cond_batch=32)
    build_s = time.time() - t0
    mask = fine_bin_mask(np.asarray(grid.sigma), K, delta=0.02)
    frac = float(mask.mean())
    return frac, build_s


def kernel_rate(frac, wn_out, nchain=None, nrep=None):
    if nchain is None:
        on_gpu = jax.default_backend() == "gpu"
        nchain, nrep = (512, 10) if on_gpu else (4, 1)
    """Folded eclipse/transit evals/s on synthetic tables with a
    round(frac*W) fine / rest smooth split (demo shapes: 100 layers,
    27 T-nodes, one molecule)."""
    from bart_tpu.rt.fused import (fused_eclipse, fused_eclipse_folded,
                                   fused_transit, fused_transit_folded)
    from bart_tpu.rt.eclipse import expsum_weights
    from bart_tpu.rt.transit_geom import slant_geometry

    W = len(wn_out)
    L, R = 100, 27
    n_f = int(round(frac * W))
    n_s = W - n_f
    rng = np.random.default_rng(0)
    f32 = jnp.float32
    tabk = jnp.asarray(rng.random((K, R, L, n_f)) * 1e-22, f32)
    tabs = jnp.asarray(rng.random((R, L, n_s)) * 1e-22, f32)
    wn_f = jnp.asarray(wn_out[:n_f], f32)
    wn_s = jnp.asarray(wn_out[n_f:], f32)
    mu, muw = expsum_weights(8)
    mu, muw = jnp.asarray(mu, f32), jnp.asarray(muw, f32)
    wrows = jnp.asarray(1e-3 + rng.random((nchain, L, R)) * 1e4, f32)
    T = jnp.asarray(rng.uniform(900, 2500, (nchain, L)), f32)
    rad = np.sort(rng.uniform(9.0e9, 9.7e9, (nchain, L)), axis=1)[:, ::-1]
    drp = jnp.asarray(
        np.concatenate([np.zeros((nchain, 1)),
                        rad[:, :-1] - rad[:, 1:]], axis=1), f32)
    G, wgt = jax.vmap(slant_geometry)(jnp.asarray(rad.copy(), f32))

    # tables are jit ARGUMENTS: closure-captured device arrays are
    # embedded as constants in the compile request (an 861 MB fine
    # table overflows the remote-compile request body)
    def eclipse(tk, ts, wr, t, d):
        parts = [fused_eclipse_folded(tk, wn_f, mu, muw, wr, t, d,
                                      powers=True)]
        if n_s:
            parts.append(fused_eclipse(ts, wn_s, mu, muw, wr, t, d,
                                       powers=True))
        return jnp.concatenate(parts) if len(parts) > 1 else parts[0]

    def transit(tk, ts, wr, g, w):
        parts = [fused_transit_folded(tk, wr, g, w)]
        if n_s:
            parts.append(fused_transit(ts, wr, g, w))
        return jnp.concatenate(parts) if len(parts) > 1 else parts[0]

    out = {}
    fe = jax.jit(jax.vmap(eclipse, in_axes=(None, None, 0, 0, 0)))
    ft = jax.jit(jax.vmap(transit, in_axes=(None, None, 0, 0, 0)))
    for name, fn, args in (("eclipse", fe, (tabk, tabs, wrows, T, drp)),
                           ("transit", ft, (tabk, tabs, wrows, G, wgt))):
        r = fn(*args)
        assert bool(np.all(np.isfinite(np.asarray(r))))
        best = np.inf
        for _ in range(3):
            t0 = time.time()
            for _ in range(nrep):
                r = fn(*args)
            float(jnp.sum(r))          # host read = barrier
            best = min(best, (time.time() - t0) / nrep)
        out[name] = nchain / best
    return out


def main(argv):
    sizes = [int(float(a)) for a in argv[1:]] or [30_000, 300_000,
                                                  1_000_000]
    wn_out = WN_LO + 1.0 * np.arange(int(WN_HI - WN_LO) + 1)
    print(f"# backend={jax.default_backend()}  K={K}  "
          f"Wout={len(wn_out)}  subsampled conds {NT_SUB}x{NLAYER_SUB}")
    rows = []
    for n in sizes:
        frac, build_s = fine_fraction(n, wn_out)
        row = dict(nlines=n, fine_frac=round(frac, 3),
                   sub_build_s=round(build_s, 1))
        if n == sizes[0]:
            frac_full, _ = fine_fraction(n, wn_out, full_conds=True)
            row["fine_frac_full_conds"] = round(frac_full, 3)
        rates = kernel_rate(row.get("fine_frac_full_conds", frac), wn_out)
        row.update({f"evals_per_s_{k}": round(v) for k, v in rates.items()})
        rows.append(row)
        print("# " + json.dumps(row), flush=True)
    print(json.dumps(dict(metric="fold_density", K=K, rows=rows)))


if __name__ == "__main__":
    main(sys.argv)
