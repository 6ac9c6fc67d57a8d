#!/usr/bin/env python
"""Sampler-efficiency sweep on the WASP-12b regression problem.

Round-5 directive: effective-samples/s is the sampler's real output
metric (evals/s times mixing quality), and `snooker_frac` / `z_thin` /
`fgamma` were untuned defaults.  This script stages the flagship
WASP-12b problem ONCE (same cfg as examples/run_wasp12b.py, full
mode), then runs the full-length retrieval (numit=1e5, 10 chains)
for each knob setting and records

    min/median bulk ESS per second, acceptance, split-R-hat max

into ``sampler_sweep.json`` next to this script.  Runs share one
process (and its compiled programs), so points are comparable; the
measured optimum becomes the shipped default (driver/config.py).

Usage: python examples/sampler_sweep.py [--points N] [--numit N]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CFG = os.path.join(REPO, "examples", "wasp12b_eclipse.cfg")

# star design around the shipped defaults (0.1, 10, fgamma=1.0 with
# burn-in deadband adaptation), plus combination candidates
POINTS = [
    {"name": "baseline", "snooker_frac": 0.1, "z_thin": 10, "fgamma": 1.0},
    {"name": "sf0.0", "snooker_frac": 0.0, "z_thin": 10, "fgamma": 1.0},
    {"name": "sf0.3", "snooker_frac": 0.3, "z_thin": 10, "fgamma": 1.0},
    {"name": "sf0.5", "snooker_frac": 0.5, "z_thin": 10, "fgamma": 1.0},
    {"name": "zt3", "snooker_frac": 0.1, "z_thin": 3, "fgamma": 1.0},
    {"name": "zt30", "snooker_frac": 0.1, "z_thin": 30, "fgamma": 1.0},
    {"name": "zt60", "snooker_frac": 0.1, "z_thin": 60, "fgamma": 1.0},
    {"name": "zt100", "snooker_frac": 0.1, "z_thin": 100, "fgamma": 1.0},
    {"name": "fg0.6", "snooker_frac": 0.1, "z_thin": 10, "fgamma": 0.6},
    {"name": "fg1.5", "snooker_frac": 0.1, "z_thin": 10, "fgamma": 1.5},
    {"name": "sf0.3_zt3", "snooker_frac": 0.3, "z_thin": 3, "fgamma": 1.0},
    {"name": "sf0.5_zt3", "snooker_frac": 0.5, "z_thin": 3, "fgamma": 1.0},
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--numit", type=int, default=100000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seeds (overrides --seed)")
    ap.add_argument("--points", default=None,
                    help="comma-separated point names (default: all)")
    ap.add_argument("--out", default=os.path.join(
        REPO, "examples", "sampler_sweep.json"))
    args = ap.parse_args(argv)

    import numpy as np

    if not os.path.isfile(
        os.path.join(REPO, "examples", "demo_inputs", "wasp12b_4mol.tli.npz")
    ):
        sys.path.insert(0, os.path.join(REPO, "examples"))
        import make_demo_inputs

        make_demo_inputs.main(os.path.join(REPO, "examples", "demo_inputs"))

    from bart_tpu.driver.config import load_config
    from bart_tpu.driver.pipeline import Pipeline
    from bart_tpu.inference.retrieval import run_mcmc

    outdir = os.path.join(REPO, "examples", "wasp12b_out_sweep")
    cfg = load_config(CFG, {"loc_dir": outdir, "nchains": "10",
                            "burnin": "2000", "plots": "False"})
    p = Pipeline(cfg)
    pressure = p.stage_pressure()
    elems = p.stage_abundances()
    atm = p.stage_atmosphere(pressure, elems)
    wn = cfg.wavenumber_grid()
    tli = p.stage_linelist(wn)
    grid = p.stage_opacity(tli, wn, pressure, atm)
    fm, like, space = p.stage_forward(atm, wn, grid)

    points = POINTS
    if args.points:
        want = set(args.points.split(","))
        points = [pt for pt in POINTS if pt["name"] in want]

    seeds = ([int(x) for x in args.seeds.split(",")]
             if args.seeds else [args.seed])
    rows = []
    for seed in seeds:
      for pt in points:
        t0 = time.time()
        res = run_mcmc(
            like, space,
            nchains=cfg.nchains, numit=args.numit, burnin=cfg.burnin,
            walk="snooker", seed=seed, verbose=False,
            grtest=True,
            snooker_frac=pt["snooker_frac"], z_thin=pt["z_thin"],
            fgamma=pt["fgamma"],
            dtype=p.dtype,
        )
        dt = time.time() - t0
        ess = np.asarray(res.ess)
        row = {
            **pt,
            "seed": seed,
            "mcmc_s": round(dt, 1),
            "samples_per_s": round(res.niter_total / dt, 1),
            "accept": round(float(res.accept_rate), 4),
            "fgamma_final": round(float(res.fgamma_final), 3),
            "split_rhat_max": round(float(np.max(res.psrf_rank)), 4),
            "ess_min": round(float(np.nanmin(ess))),
            "ess_median": round(float(np.nanmedian(ess))),
            "ess_per_s_min": round(float(np.nanmin(ess)) / dt, 2),
            "ess_per_s_median": round(float(np.nanmedian(ess)) / dt, 2),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"# sweep written to {args.out}")


if __name__ == "__main__":
    main()
