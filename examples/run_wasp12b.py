#!/usr/bin/env python
"""WASP-12b-class regression retrieval.

The reference names its WASP-12b example as *the* regression test
(reference: doc/BART_user_manual/BART_user_manual.tex:354-359;
examples/WASP-12b/BART.cfg).  This script is bart_tpu's committed
equivalent: a 4-molecule (H2O/CO2/CO/CH4) eclipse retrieval over the
4 Spitzer IRAC channels against synthetic depths generated from a
known truth, asserting convergence AND truth recovery, and writing its
timing numbers.

Modes:

  python examples/run_wasp12b.py            # full: numit=1e5, 50 chains,
                                            # pinned cfg data (numeric
                                            # regression; run on a GPU)
  python examples/run_wasp12b.py --short    # CI-sized: reduced grids +
                                            # numit, data regenerated
                                            # from the truth at the
                                            # reduced resolution
                                            # (structural regression;
                                            # runs on CPU in ~2 min)

Both modes write ``wasp12b_timing.json`` into the output directory and
exit non-zero if any assertion fails.

The --short mode regenerates the synthetic observations from the truth
parameters at its own (coarsened) resolution, because the committed
depths in wasp12b_eclipse.cfg encode the full 100-layer/1-cm^-1 grid:
at reduced resolution the model at truth shifts by more than the 2.5%
error bars, which would test discretization, not the sampler.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CFG = os.path.join(REPO, "examples", "wasp12b_eclipse.cfg")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--short", action="store_true",
                    help="CI-sized run (reduced grids + iterations)")
    ap.add_argument("--fold", action="store_true",
                    help="publication-accuracy mode: rtosamp=32 folded "
                         "kernels (<1e-4 band flux) via "
                         "wasp12b_eclipse_fold.cfg")
    ap.add_argument("--outdir", default=None)
    args = ap.parse_args(argv)

    import numpy as np

    # inputs (synthetic 4-molecule TLI + CIA) are generated, not shipped
    if not os.path.isfile(
        os.path.join(REPO, "examples", "demo_inputs", "wasp12b_4mol.tli.npz")
    ):
        sys.path.insert(0, os.path.join(REPO, "examples"))
        import make_demo_inputs

        make_demo_inputs.main(os.path.join(REPO, "examples", "demo_inputs"))

    from bart_tpu.driver.config import load_config, load_data_array
    from bart_tpu.driver.pipeline import Pipeline

    cfg_path = CFG
    if args.fold:
        assert not args.short, "--fold and --short are exclusive"
        cfg_path = os.path.join(REPO, "examples",
                                "wasp12b_eclipse_fold.cfg")
    outdir = args.outdir or os.path.join(
        REPO, "examples",
        "wasp12b_out" + ("_short" if args.short else "")
        + ("_fold" if args.fold else "")
    )
    overrides = {"loc_dir": outdir}
    if args.short:
        overrides.update({
            "numit": "60000", "nchains": "16", "burnin": "2000",
            "n_layers": "40", "wndelt": "4.0", "tempdelt": "400",
            "nwidth": "20", "grexit": "False", "plots": "False",
            "opacityfile": "opacity_4mol_short.npz",
        })
    else:
        # the reference's own chain count (examples/WASP-12b/BART.cfg
        # nchains=10): at numit=1e5 that is 10k iterations per chain —
        # chains must be LONGER than the posterior's autocorrelation
        # time for split-Rhat to converge (50 short chains maximized
        # device throughput but left 2k-iter chains that cannot mix
        # the curved kappa/g1/beta/abundance degeneracy); burn-in 2000
        # gives the gamma adaptation a ~20-block window
        overrides.update({"nchains": "10", "burnin": "2000"})
    cfg = load_config(cfg_path, overrides)

    p = Pipeline(cfg)
    t_setup = time.time()
    pressure = p.stage_pressure()
    elems = p.stage_abundances()
    atm = p.stage_atmosphere(pressure, elems)
    wn = cfg.wavenumber_grid()
    # mirror Pipeline.run(): with rtosamp (fold_K) > 1 the line list
    # and opacity grid live on the K-times-finer midpoint grid while
    # outputs stay on wn (stage_forward folds the table itself)
    if cfg.fold_K > 1:
        from bart_tpu.utils.grids import folded_fine_grid

        wn_rt = folded_fine_grid(wn, cfg.fold_K)
    else:
        wn_rt = wn
    tli = p.stage_linelist(wn_rt)
    grid = p.stage_opacity(tli, wn_rt, pressure, atm)
    fm, like, space = p.stage_forward(atm, wn, grid)
    setup_s = time.time() - t_setup

    import jax.numpy as jnp

    truth_full = np.asarray(cfg.params, np.float64)
    truth_free = truth_full[space.ifree]
    names = [space.pnames[i] for i in space.ifree]

    bf, _, ok = fm.jitted()(jnp.asarray(truth_full, fm.dtype))
    bf = np.asarray(bf)
    assert bool(ok), "truth parameters rejected by the forward model"

    data = load_data_array(cfg.data)
    uncert = load_data_array(cfg.uncert)
    if args.short:
        # regenerate observations from truth at this resolution
        data = bf.copy()
        uncert = 0.025 * data
        from bart_tpu.inference.likelihood import Likelihood

        like = Likelihood(fm, space, data, uncert, wlike=cfg.wlike)
        pull_truth = 0.0
    else:
        # numeric regression: the committed depths ARE the model at
        # truth on the committed grid (uncert = 2.5% of depth)
        pull_truth = float(np.max(np.abs(bf - data) / uncert))
        print(f"model(truth) vs committed depths: max pull "
              f"{pull_truth:.3f} sigma")
        assert pull_truth < 0.5, (
            f"committed WASP-12b depths no longer reproduce the truth "
            f"model (max pull {pull_truth:.2f} sigma) — the forward "
            f"model changed numerically")

    t0 = time.time()
    result = p.stage_mcmc(like, space)
    mcmc_s = time.time() - t0

    post = result.posterior                     # [nchain, nfree, niter]
    mean = post.mean(axis=(0, 2))
    std = post.std(axis=(0, 2))
    pulls = (mean - truth_free) / np.maximum(std, 1e-12)
    psrf_max = float(np.nanmax(result.psrf))
    rhat = np.asarray(result.psrf_rank)

    # Split the directions into data-CONSTRAINED vs prior-PLATEAU: a
    # direction whose posterior std is well below the uniform-prior std
    # (width/sqrt(12)) is constrained by the data; the rest are plateau
    # directions where GR converges only at the prior-mixing timescale.
    prior_std = (space.free_max - space.free_min) / np.sqrt(12.0)
    constrained = std < 0.5 * prior_std

    print(f"\n{'param':>8} {'truth':>8} {'mean':>9} {'std':>8} "
          f"{'pull':>6} {'Rhat':>7} {'kind':>12}")
    for n, t, m, s, z, r, c in zip(names, truth_free, mean, std, pulls,
                                   rhat, constrained):
        print(f"{n:>8} {t:8.3f} {m:9.3f} {s:8.3f} {z:6.2f} {r:7.4f} "
              f"{'constrained' if c else 'plateau':>12}")
    print(f"psrf max {psrf_max:.4f}  split-Rhat max {np.max(rhat):.4f}  "
          f"accept {result.accept_rate:.2f}  fgamma {result.fgamma_final:.3f}  "
          f"MCMC {mcmc_s:.1f} s "
          f"({result.niter_total / mcmc_s:.0f} samples/s)")

    # chi^2 of the single best sample: the sampler must FIND the
    # truth-model region (data are noise-free model-at-truth, so the
    # best chi^2 is ~0 when it does, ~>1/datum when it doesn't)
    chi2_best = float(-2.0 * result.best_loglike)

    # --- assertions -------------------------------------------------
    # This 4-datum posterior has directions that are prior-plateau
    # (abundances below detectability are all equally likely), where
    # cross-chain mixing happens at the prior timescale.  The sharp
    # regression checks are model(truth)-vs-data, best-fit chi^2,
    # truth pulls, AND (round 4) rank-normalized split-R-hat < 1.1 on
    # every data-CONSTRAINED direction plus acceptance >= 0.15 — the
    # sampler-efficiency bar the round-3 run (accept 0.046, GR 1.27)
    # did not meet before boundary reflection + burn-in gamma
    # adaptation + the deeper snooker archive.
    # short mode is a STRUCTURAL smoke test (16 chains x ~1.75k
    # post-burn-in iterations cannot converge split-Rhat below ~1.4);
    # the convergence bar proper is the full mode's 1.1
    rhat_con_bound = 1.5 if args.short else 1.1
    rhat_all_bound = 2.5 if args.short else 1.6
    accept_floor = 0.10 if args.short else 0.15
    pull_bound = 3.5
    failures = []
    rc = float(np.max(rhat[constrained])) if constrained.any() else 1.0
    if not (rc < rhat_con_bound):
        failures.append(
            f"constrained-direction split-Rhat {rc:.3f} >= "
            f"{rhat_con_bound}")
    if not (float(np.max(rhat)) < rhat_all_bound):
        failures.append(
            f"split-Rhat {float(np.max(rhat)):.3f} >= {rhat_all_bound}")
    if not (chi2_best < len(data)):
        failures.append(
            f"best chi2 {chi2_best:.2f} >= ndata={len(data)} — sampler "
            f"never found the truth-model region")
    bad = np.abs(pulls) > pull_bound
    if bad.any():
        failures.append(
            "truth outside {}-sigma for: {}".format(
                pull_bound,
                ", ".join(f"{n} ({z:+.1f})"
                          for n, z, b in zip(names, pulls, bad) if b),
            ))
    if not (result.accept_rate >= accept_floor):
        failures.append(
            f"accept rate {result.accept_rate:.3f} < {accept_floor}")

    timing = {
        "mode": ("short" if args.short
                 else "fold" if args.fold else "full"),
        "backend": __import__("jax").default_backend(),
        "setup_s": round(setup_s, 2),
        "mcmc_s": round(mcmc_s, 2),
        "samples_per_s": round(result.niter_total / mcmc_s, 1),
        "numit": int(cfg.numit), "nchains": int(cfg.nchains),
        "psrf_max": round(psrf_max, 4),
        "split_rhat": {n: round(float(r), 4)
                       for n, r in zip(names, rhat)},
        "split_rhat_constrained_max": round(rc, 4),
        "constrained": [n for n, c in zip(names, constrained) if c],
        "chi2_best": round(chi2_best, 4),
        "accept_rate": round(float(result.accept_rate), 4),
        "fgamma_final": round(float(result.fgamma_final), 4),
        "ess": ({n: round(float(e)) for n, e in zip(names, result.ess)}
                if result.ess is not None else None),
        # effective-samples/s is THE sampler efficiency number (raw
        # samples/s times mixing quality); min over parameters is the
        # binding one
        "ess_per_s_min": (round(float(np.nanmin(result.ess)) / mcmc_s, 2)
                          if result.ess is not None else None),
        "ess_per_s_median": (
            round(float(np.nanmedian(result.ess)) / mcmc_s, 2)
            if result.ess is not None else None),
        "max_abs_pull": round(float(np.max(np.abs(pulls))), 3),
        "truth_model_max_pull_sigma": round(pull_truth, 4),
        "passed": not failures,
    }
    tpath = os.path.join(outdir, "wasp12b_timing.json")
    with open(tpath, "w") as f:
        json.dump(timing, f, indent=1)
    print(f"timing written to {tpath}")

    if failures:
        print("REGRESSION FAILURES:\n  " + "\n  ".join(failures))
        return 1
    print("WASP-12b regression PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
