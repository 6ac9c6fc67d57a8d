#!/usr/bin/env python
"""bart_tpu benchmark: likelihood evaluations per second per GPU.

Runs the demo-CH4-class forward model (100 layers, 2501 output
wavenumbers, 30k lines, opacity-grid hot path) batched over a chain
ensemble — the workload of the reference's MCMC hot loop (SURVEY.md
section 3.2).  The primary metric (eclipse geometry) is measured and
its JSON line printed FIRST; everything else (transit geometry,
folded-rtosamp modes) follows on stderr, under a deadline.

Baseline: the reference achieves O(3-10) likelihood evals/s/core on
CPU (BASELINE.md, "Implied likelihood throughput"); vs_baseline is
measured against the optimistic end (10 evals/s).

Prints ONE JSON line (primary metric; extra measurements on stderr):
  {"metric": "likelihood_evals_per_s", "value": N, "unit": "evals/s/chip",
   "vs_baseline": N/10, "device": {...}}

Needs a GPU and fails without one.  A failed extra is reported on
stderr and makes the exit code non-zero, after the primary line.
Budget: BENCH_BUDGET_S (default 420 s); BENCH_FOLD=0 skips the folded
extras.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

NLAYER, NWAVE, NLINES, NCHAIN, NREP = 100, 2501, 30000, 512, 20

T_START = time.time()
DEADLINE = T_START + float(os.environ.get("BENCH_BUDGET_S", "420"))


def _left():
    return DEADLINE - time.time()


def _time_batched(fb, params, nrep, rounds=3):
    """Serialized (chained-dependency) batch timing.

    Each iteration's input depends on the previous iteration's output
    and the loop ends with a HOST read of the result — this measures
    what an MCMC step actually costs (step t+1 depends on step t).
    Returns (best seconds per batch, median-vs-best spread in %).
    """
    import jax.numpy as jnp

    out = fb(params)
    assert bool(np.all(np.isfinite(np.asarray(out[0])))), "non-finite flux"
    assert bool(np.all(np.asarray(out[2]))), "invalid forward evals"
    times = []
    for _round in range(rounds):
        p = params
        t0 = time.time()
        for _ in range(nrep):
            out = fb(p)
            p = params + 0.0 * jnp.sum(out[0])   # serialize the chain
        assert np.isfinite(float(jnp.sum(out[0])))  # host read = barrier
        times.append((time.time() - t0) / nrep)
    best = min(times)
    spread_pct = (
        100.0 * (float(np.median(times)) - best) / best
        if len(times) > 1 else 0.0
    )
    print("# rounds [ms]: " + ", ".join(f"{t*1e3:.2f}" for t in times),
          file=sys.stderr)
    return best, spread_pct


def _with_radius(params, fm):
    """Insert the transit radius parameter after the PT block."""
    import jax.numpy as jnp

    p = np.asarray(params)
    return jnp.asarray(np.concatenate(
        [p[:, :5], np.full((len(p), 1), fm.r0_km), p[:, 5:]], axis=1),
        fm.dtype)


def _extras(ge, params):
    """Secondary measurements: transit geometry and the folded modes,
    each under the deadline; all output goes to stderr."""
    if _left() < 45:
        print(f"# extras skipped: {_left():.0f}s left in budget",
              file=sys.stderr)
        return
    fmt = ge._build_problem(nlayer=NLAYER, nwave=NWAVE, nlines=NLINES,
                            cache=True, solution="transit")
    dt_t, sp_t = _time_batched(fmt.batched(), _with_radius(params, fmt),
                               NREP, rounds=3 if _left() > 90 else 1)
    print(f"# transit: batch {NCHAIN} in {dt_t*1e3:.2f} ms; "
          f"{NCHAIN/dt_t:.0f} evals/s (spread {sp_t:.0f}%)",
          file=sys.stderr)

    # folded rtosamp=32 (publication accuracy, <1e-4 band flux), with
    # bf16-stored fine tables (half the table bytes)
    if os.environ.get("BENCH_FOLD", "1") == "0":
        return
    for geom, quad, adapt in (("eclipse", "expsum", 0.02),
                              ("transit", "raygrid", 0.02)):
        if _left() < 100:
            print(f"# folded {geom} skipped: {_left():.0f}s left "
                  f"in budget", file=sys.stderr)
            break
        fmf = ge._build_problem(
            nlayer=NLAYER, nwave=NWAVE, nlines=NLINES, cache=True,
            fold=32, fold_adapt=adapt, quadrature=quad, solution=geom,
            fold_bf16=True)
        frac = (len(fmf._idx_fine) / NWAVE
                if getattr(fmf, "_idx_fine", None) is not None else 1.0)
        pf = params if geom == "eclipse" else _with_radius(params, fmf)
        dt_f, sp_f = _time_batched(fmf.batched(), pf, NREP,
                                   rounds=3 if _left() > 120 else 1)
        print(f"# folded rtosamp=32 {geom} adapt={adapt} {quad} "
              f"(fine frac {frac:.2f}): batch {NCHAIN} in "
              f"{dt_f*1e3:.2f} ms; {NCHAIN/dt_f:.0f} evals/s "
              f"(spread {sp_f:.0f}%)", file=sys.stderr)


def main():
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found "
                         f"{devs[0].platform!r}")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}

    from bart_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import __graft_entry__ as ge

    t0 = time.time()
    fm = ge._build_problem(nlayer=NLAYER, nwave=NWAVE, nlines=NLINES,
                           cache=True)
    print(f"# opacity grid {tuple(fm.sigma.shape)} ready in "
          f"{time.time() - t0:.1f}s on {device['kind']} (cached after the "
          f"first run)", file=sys.stderr)

    rng = np.random.default_rng(0)
    base = np.array([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5])
    params = jnp.asarray(
        np.tile(base, (NCHAIN, 1)) + rng.normal(0, 0.005, (NCHAIN, 6)),
        fm.dtype,
    )

    t0 = time.time()
    rounds = 3 if _left() > 60 else 1
    dt, spread = _time_batched(fm.batched(), params, NREP, rounds=rounds)
    print(f"# eclipse: compile+first {time.time()-t0-rounds*NREP*dt:.1f}s; "
          f"batch {NCHAIN} in {dt*1e3:.2f} ms ({rounds} timing rounds)",
          file=sys.stderr)
    evals_per_s = NCHAIN / dt

    # PRIMARY METRIC — printed before any secondary measurement so a
    # budget overrun in the extras can never blank it.  spread_pct:
    # median-vs-best timing round within this process.
    print(json.dumps({
        "metric": "likelihood_evals_per_s",
        "value": round(evals_per_s, 1),
        "unit": "evals/s/chip",
        "vs_baseline": round(evals_per_s / 10.0, 1),
        "spread_pct": round(spread, 1),
        "device": device,
    }), flush=True)

    try:
        _extras(ge, params)
    except Exception as e:
        print(f"# extras failed (primary already reported): {e!r}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
