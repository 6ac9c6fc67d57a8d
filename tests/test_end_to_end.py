"""End-to-end retrieval: the demo CH4 eclipse slice (SURVEY.md section 7).

Generates synthetic eclipse depths from a known truth with the full
forward model (PT-line profile + CH4 opacity + band integration), then
runs the snooker retrieval and checks the truth is recovered within
posterior uncertainty — the regression-test role the WASP-12b example
plays for the reference (manual tex:354-359).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bart_tpu.inference.likelihood import Likelihood, ParamSpace
from bart_tpu.inference.retrieval import run_mcmc
from test_rt import make_demo_forward, DEMO_PARAMS

TRUTH = np.array([-1.8, 0.1, 1.0, 0.0, 0.95, -0.7])


@pytest.fixture(scope="module")
def demo_problem():
    fm = make_demo_forward("eclipse")
    f = fm.jitted()
    bf, _, valid = f(jnp.asarray(TRUTH))
    assert bool(valid)
    data = np.asarray(bf)
    uncert = 0.03 * data  # 3% error bars
    rng = np.random.default_rng(42)
    data_noisy = data + rng.normal(0, 1, data.shape) * uncert
    return fm, data_noisy, uncert


@pytest.mark.slow
def test_demo_eclipse_retrieval(demo_problem):
    fm, data, uncert = demo_problem
    # demo cfg free-parameter setup (examples/demo/BART_eclipse.cfg):
    # kappa, g1 free; g2, alpha fixed; beta, CH4 free
    space = ParamSpace(
        pinit=DEMO_PARAMS.copy(),
        pmin=[-5.0, -2.0, -2.0, 0.0, 0.55, -9.0],
        pmax=[-1.0, 1.0, 1.0, 1.0, 1.2, 1.5],
        stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 0.1],
        pnames=["kappa", "g1", "g2", "alpha", "beta", "CH4"],
    )
    like = Likelihood(fm, space, data, uncert)
    res = run_mcmc(
        like, space, nchains=8, numit=48000, burnin=600, walk="snooker",
        seed=7, block=150, verbose=False, grtest=True,
    )
    flat = res.posterior.transpose(1, 0, 2).reshape(space.nfree, -1)
    mean = flat.mean(1)
    std = flat.std(1)
    truth_free = TRUTH[space.ifree]

    # Direction split (as in examples/run_wasp12b.py): a direction
    # whose posterior std is well below the uniform-prior std is
    # data-constrained; the rest are prior-plateau directions.  The
    # demo CH4 marginal is legitimately plateau-dominated at 3% noise:
    # the no-CH4 solution sits only delta-chi2 ~ 3.0 above the truth
    # mode (measured by profiling chi2 over pinned CH4 with the other
    # parameters re-optimized) while the plateau spans ~7 dex of
    # prior, so the correct posterior mean is pulled far from truth —
    # round-3's tighter truth-pull assertion passed only because
    # out-of-bounds auto-rejects suppressed plateau exploration.
    prior_std = (space.free_max - space.free_min) / np.sqrt(12.0)
    constrained = std < 0.5 * prior_std

    # constrained directions recover truth within 3.5 sigma:
    pulls = np.abs(mean - truth_free) / np.maximum(std, 1e-12)
    assert np.all(pulls[constrained] < 3.5), (
        mean, std, truth_free, pulls, constrained)
    # every direction's central 99% credible interval covers truth:
    q = np.percentile(flat, [0.5, 99.5], axis=1)
    assert np.all((truth_free > q[0]) & (truth_free < q[1])), (
        q, truth_free)

    # best fit reproduces the data well (chi2/dof ~ 1):
    chi2 = -2.0 * res.best_loglike
    assert chi2 / len(data) < 3.0

    # convergence reasonably progressed (rank-normalized split-Rhat;
    # plateau directions mix at the prior timescale, so the bound is
    # looser than the constrained-direction WASP-12b bar):
    assert np.all(res.psrf_rank < 1.35), res.psrf_rank


def test_demo_transit_retrieval_shape(demo_problem):
    """Transit geometry end-to-end (shorter: just verify the machinery)."""
    fm = make_demo_forward("transit")
    f = fm.jitted()
    params = np.concatenate([TRUTH[:5], [fm.r0_km], TRUTH[5:]])
    bf, _, valid = f(jnp.asarray(params))
    assert bool(valid)
    data = np.asarray(bf)
    uncert = 0.01 * data
    space = ParamSpace(
        pinit=params.copy(),
        pmin=[-5.0, -2.0, -2.0, 0.0, 0.55, 0.8 * fm.r0_km, -9.0],
        pmax=[-1.0, 1.0, 1.0, 1.0, 1.2, 1.2 * fm.r0_km, 1.5],
        stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 100.0, 0.1],
    )
    like = Likelihood(fm, space, data, uncert)
    res = run_mcmc(like, space, nchains=6, numit=6000, burnin=200,
                   walk="demc", seed=8, block=100, verbose=False,
                   grtest=False)
    assert res.posterior.shape[0] == 6
    assert np.isfinite(res.best_loglike)
    # best-fit chi2 should be small (we started at truth)
    assert -2 * res.best_loglike < 10.0


@pytest.mark.slow
def test_retrieval_other_pt_models(demo_problem):
    """Exercise a second PT family end-to-end (madhu_noinv, 5 params)."""
    import numpy as np

    from bart_tpu.io.kurucz import blackbody_star
    from bart_tpu.io.filters import read_filter as rf
    from bart_tpu.io.tep import PlanetSystem
    from bart_tpu.linelist.tli import synthetic_linelist
    from bart_tpu.obs.bands import build_band_matrix
    from bart_tpu.opacity.grid import build_opacity_grid
    from bart_tpu.rt.forward import ForwardConfig, ForwardModel
    from bart_tpu.utils.grids import pressure_grid

    from test_rt import DEMO, DEMO_TEP
    system = PlanetSystem.from_tep(DEMO_TEP)
    pressure = pressure_grid(30, 1e-5, 100.0)
    wn = np.arange(2500.0, 5001.0, 20.0)
    ll = synthetic_linelist("CH4", 2500.0, 5000.0, 800, seed=13)
    grid = build_opacity_grid({"CH4": ll}, wn,
                              np.arange(400.0, 3001.0, 400.0), pressure,
                              cond_batch=40, dtype=jnp.float64)
    filters = [rf(f"{DEMO}/fdemo{i:02d}.dat")
               for i in range(1, 11)]
    starfl, _ = blackbody_star(wn, system.t_star)
    bands = build_band_matrix(wn, filters, star_flux=starfl,
                              rprs=system.rprs)
    config = ForwardConfig(solution="eclipse", pt_type="madhu_noinv",
                           molfit=("CH4",))
    fm = ForwardModel(config, wn_grid=wn, pressure=pressure,
                      species=["H2", "He", "CH4"],
                      base_abundances=np.tile([0.85, 0.149, 1e-3], (30, 1)),
                      opacity=grid, system=system, bands=bands,
                      dtype=jnp.float64)
    # params: a1, a2, p1, p3, T3, CH4
    truth = np.array([0.4, 0.25, 0.005, 2.0, 1500.0, -0.5])
    bf, _, valid = fm.jitted()(jnp.asarray(truth))
    assert bool(valid)
    data = np.asarray(bf)
    space = ParamSpace(
        pinit=truth,
        pmin=[0.2, 0.1, 1e-4, 0.5, 800.0, -9.0],
        pmax=[0.7, 0.5, 0.05, 10.0, 2500.0, 1.5],
        stepsize=[0.01, 0.01, 0.001, 0.1, 10.0, 0.1],
    )
    like = Likelihood(fm, space, data, 0.02 * data)
    rng = np.random.default_rng(14)
    init = np.clip(
        truth[space.ifree][None, :]
        * (1 + rng.normal(0, 0.02, (6, space.nfree))),
        space.free_min, space.free_max,
    )
    res = run_mcmc(like, space, nchains=6, numit=6000, burnin=200,
                   walk="snooker", seed=14, block=100, verbose=False,
                   grtest=False, init=init)
    assert np.isfinite(res.best_loglike)
    assert -2 * res.best_loglike < 10.0

    # isothermal family too (1 param + CH4):
    config_iso = ForwardConfig(solution="eclipse", pt_type="iso",
                               molfit=("CH4",))
    fm_iso = ForwardModel(config_iso, wn_grid=wn, pressure=pressure,
                          species=["H2", "He", "CH4"],
                          base_abundances=np.tile([0.85, 0.149, 1e-3],
                                                  (30, 1)),
                          opacity=grid, system=system, bands=bands,
                          dtype=jnp.float64)
    bf_iso, _, v_iso = fm_iso.jitted()(jnp.asarray([1400.0, -0.5]))
    assert bool(v_iso) and np.all(np.asarray(bf_iso) > 0)
