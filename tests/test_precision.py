"""f32 vs f64 retrieval fidelity.

The pipeline defaults to float32 on the accelerator (driver/pipeline.py) while the
reference is float64 throughout (SURVEY.md section 7 "Precision").
Two complementary checks, calibrated by a measured seed-to-seed MC
noise study (docs/LINE_SAMPLING.md, accuracy findings):

1. DETERMINISTIC (the strong one): evaluate the f32 and f64
   log-likelihoods on the same posterior-typical sample set.  If
   max |logL32 - logL64| = eps over the typical set, the f32 posterior
   density is within a factor exp(eps) of the f64 posterior everywhere
   it matters — no sampling noise involved.  Measured eps = 1e-4;
   pinned at 0.02.

2. STATISTICAL: a full f32 retrieval recovers the truth and matches an
   f64 run's posterior moments within bounds set by the measured
   seed-to-seed scatter of f64-vs-f64 runs (means differ by up to
   0.65 sigma between seeds at this chain length — identical
   trajectories are impossible since round-off grows chaotically
   through Metropolis accepts, so same-seed f32/f64 runs are
   effectively independent-seed runs).
"""

import numpy as np
import pytest

# the whole module is a >=5-min precision study (shared fixture
# builds f32 AND f64 retrievals): slow tier
pytestmark = pytest.mark.slow

import jax
import jax.numpy as jnp

from bart_tpu.inference.likelihood import Likelihood, ParamSpace
from bart_tpu.inference.retrieval import run_mcmc
from test_rt import make_demo_forward

TRUTH = np.array([-1.8, 0.1, 1.0, 0.0, 0.95, -0.7])
# 44k left the beta marginal's width estimate under-mixed (single-run
# widths spread 2x at that length under the round-4 sampler); 96k
# brings the moment comparisons inside the calibrated envelopes
NUMIT = 96000


@pytest.fixture(scope="module")
def problem():
    space = ParamSpace(
        pinit=TRUTH.copy(),
        pmin=[-5.0, -2.0, -2.0, 0.0, 0.55, -9.0],
        pmax=[-1.0, 1.0, 1.0, 1.0, 1.2, 1.5],
        stepsize=[0.01, 0.01, 0.0, 0.0, 0.001, 0.1],
    )
    fm64 = make_demo_forward("eclipse")
    fm32 = make_demo_forward("eclipse", dtype=jnp.float32)
    data64 = np.asarray(fm64.jitted()(jnp.asarray(TRUTH))[0])
    rng = np.random.default_rng(42)
    uncert = 0.03 * data64
    data = data64 + rng.normal(0, 1, data64.shape) * uncert
    like64 = Likelihood(fm64, space, data, uncert)
    like32 = Likelihood(fm32, space, data, uncert)
    res64 = run_mcmc(
        like64, space, nchains=8, numit=NUMIT, burnin=1000,
        walk="snooker", seed=7, block=150, verbose=False, grtest=True,
    )
    return space, fm32, data64, data, uncert, like32, like64, res64


def test_f32_forward_truncation_below_data_uncertainty(problem):
    space, fm32, data64, data, uncert, *_ = problem
    bf32, _, valid = fm32.jitted()(jnp.asarray(TRUTH, jnp.float32))
    assert bool(valid)
    fwd_err = np.abs(np.asarray(bf32, np.float64) - data64) / data64
    # f32 model truncation (~1e-5 measured) is ~3000x below the 3%
    # data uncertainty — it cannot bias this retrieval
    assert fwd_err.max() < 1e-3, fwd_err


def test_f32_loglike_matches_f64_on_typical_set(problem):
    """Importance-ratio bound: |logL32 - logL64| <= eps on the typical
    set implies the f32 posterior differs from f64 by at most a factor
    exp(eps) in density.  Measured max eps = 1.0e-4 at demo scale."""
    space, fm32, data64, data, uncert, like32, like64, res64 = problem
    flat = res64.posterior.transpose(1, 0, 2).reshape(space.nfree, -1)
    idx = np.linspace(0, flat.shape[1] - 1, 512).astype(int)
    draws = flat[:, idx].T                                # [512, nfree]

    l64 = jax.vmap(lambda p: like64(p)[0])(jnp.asarray(draws))
    l32 = jax.vmap(lambda p: like32(p)[0])(
        jnp.asarray(draws, jnp.float32))
    l64 = np.asarray(l64, np.float64)
    l32 = np.asarray(l32, np.float64)
    finite = np.isfinite(l64) & np.isfinite(l32)
    assert finite.mean() > 0.99          # bounds/validity agree
    d = np.abs(l32[finite] - l64[finite])
    # measured: max 1.0e-4, mean 2e-5 (docs/LINE_SAMPLING.md) — bounds
    # leave ~100x headroom while still pinning density-level fidelity
    assert d.max() < 0.02, (d.max(), d.mean())
    assert d.mean() < 0.002, d.mean()


def test_f32_retrieval_recovers_truth(problem):
    """Full f32 retrieval: truth coverage + moments within the
    measured seed-to-seed MC envelope of f64 runs UNDER THE ROUND-4
    SAMPLER (re-calibrated 2026-08-21: with boundary reflection the
    posterior legitimately carries prior-plateau mass the round-3
    sampler under-explored; f64 seeds 7/11/23 now spread kappa means
    by up to 0.94 sigma and widths by up to 1.59x, so the round-3
    0.8-sigma/1.6x bounds no longer describe same-sampler MC noise)."""
    space, fm32, data64, data, uncert, like32, like64, res64 = problem
    res32 = run_mcmc(
        like32, space, nchains=8, numit=NUMIT, burnin=1000,
        walk="snooker", seed=7, block=150, verbose=False, grtest=True,
        dtype=jnp.float32,
    )
    f64 = res64.posterior.transpose(1, 0, 2).reshape(space.nfree, -1)
    f32 = res32.posterior.transpose(1, 0, 2).reshape(space.nfree, -1)
    m64, s64 = f64.mean(1), f64.std(1)
    m32, s32 = f32.mean(1), f32.std(1)

    # calibrated envelopes (seed-to-seed f64 maxima 0.94 sigma / 1.59x,
    # bounds with ~25% headroom):
    assert np.all(np.abs(m32 - m64) < 1.2 * s64), (m32, m64, s64)
    assert np.all(np.abs(np.log(s32 / s64)) < np.log(1.8)), (s32, s64)
    # quantiles are the noisiest statistic at this Neff; density-level
    # agreement is already pinned deterministically by the
    # importance-ratio test, so this is a loose sanity bound
    q64 = np.percentile(f64, [15.87, 84.13], axis=1)
    q32 = np.percentile(f32, [15.87, 84.13], axis=1)
    smax = np.maximum(s32, s64)
    assert np.all(np.abs(q32 - q64) < 1.5 * smax), (q32, q64, smax)

    # truth inside the central 99% interval of every marginal (the
    # plateau-aware coverage check; see test_end_to_end for why a
    # truth-pull bound is wrong for the CH4 plateau direction)
    q = np.percentile(f32, [0.5, 99.5], axis=1)
    truth_free = TRUTH[space.ifree]
    assert np.all((truth_free > q[0]) & (truth_free < q[1])), (
        q, truth_free)
    assert np.all(res32.psrf_rank < 1.4), res32.psrf_rank
