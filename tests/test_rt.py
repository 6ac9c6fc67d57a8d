"""Radiative-transfer tests: analytic goldens for Planck, tau, eclipse,
transit geometry, band integration, and the full forward model."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bart_tpu import constants as const
from bart_tpu.io.filters import read_filter
from bart_tpu.io.tep import PlanetSystem
from bart_tpu.linelist.tli import synthetic_linelist
from bart_tpu.obs.bands import build_band_matrix, band_integrate
from bart_tpu.opacity.grid import build_opacity_grid
from bart_tpu.rt.eclipse import eclipse_flux, eclipse_intensity, raygrid_weights
from bart_tpu.rt.forward import ForwardConfig, ForwardModel
from bart_tpu.rt.planck import planck_wn
from bart_tpu.rt.tau import tau_slant, tau_vertical
from bart_tpu.rt.transit_geom import transit_depth

# assumed demo system and filters in the repository
# (examples/make_demo_inputs.py)
DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "examples", "demo_inputs")
DEMO_TEP = os.path.join(DEMO, "demo_system.tep")


def test_planck_stefan_boltzmann():
    # integral of pi*B over wavenumber = sigma_SB T^4 (cgs)
    T = 1500.0
    wn = np.linspace(1.0, 60000.0, 200000)
    B = np.asarray(planck_wn(jnp.asarray(wn), T))
    total = np.pi * np.trapezoid(B, wn)
    want = const.SIGMA_SB_CGS * T**4
    assert total == pytest.approx(want, rel=1e-4)


def test_planck_wien_peak():
    T = 1000.0
    wn = np.linspace(100.0, 10000.0, 100000)
    B = np.asarray(planck_wn(jnp.asarray(wn), T))
    # Wien displacement in wavenumber: wn_peak ~ 1.9611 cm-1/K * T
    assert wn[np.argmax(B)] == pytest.approx(1.9611 * T, rel=1e-3)


def test_tau_vertical_manual():
    r = jnp.array([110e5, 105e5, 100e5])  # cm, descending
    e = jnp.array([[1e-7, 2e-7], [3e-7, 4e-7], [5e-7, 6e-7]])
    tau = np.asarray(tau_vertical(e, r))
    assert tau[0, 0] == 0.0
    np.testing.assert_allclose(tau[1, 0], 0.5 * (1e-7 + 3e-7) * 5e5)
    np.testing.assert_allclose(
        tau[2, 1], 0.5 * (2e-7 + 4e-7) * 5e5 + 0.5 * (4e-7 + 6e-7) * 5e5
    )


def test_tau_slant_constant_extinction():
    # analytic: tau(b) = 2 e0 sqrt(R_top^2 - b^2) for uniform extinction
    nl = 200
    r = np.linspace(1.10e10, 1.0e10, nl)  # cm
    e0 = 1e-9
    ext = jnp.full((nl, 3), e0)
    tau = np.asarray(tau_slant(ext, jnp.asarray(r)))
    want = 2 * e0 * np.sqrt(r[0] ** 2 - r**2)
    np.testing.assert_allclose(tau[:, 0], want, rtol=5e-3)


def test_eclipse_isothermal_is_planck():
    # isothermal optically-thick atmosphere: I = B, F = pi B exactly
    nl, nw = 50, 16
    T0 = 1300.0
    wn = jnp.linspace(2500.0, 5000.0, nw)
    r = jnp.linspace(1.1e9, 1.0e9, nl)
    ext = jnp.full((nl, nw), 1e-6)  # tau_bot ~ 100
    tau = tau_vertical(ext, r)
    T = jnp.full(nl, T0)
    mu, w = raygrid_weights((0.0, 20.0, 40.0, 60.0, 80.0))
    I = np.asarray(eclipse_intensity(tau, T, wn, jnp.asarray(mu)))
    B = np.asarray(planck_wn(wn, T0))
    np.testing.assert_allclose(I, np.broadcast_to(B, I.shape), rtol=1e-6)
    F = np.asarray(eclipse_flux(tau, T, wn, jnp.asarray(mu), jnp.asarray(w)))
    np.testing.assert_allclose(F, np.pi * B, rtol=1e-6)
    # transparent atmosphere also -> pi B (surface term)
    tau0 = tau_vertical(jnp.zeros((nl, nw)), r)
    F0 = np.asarray(eclipse_flux(tau0, T, wn, jnp.asarray(mu), jnp.asarray(w)))
    np.testing.assert_allclose(F0, np.pi * B, rtol=1e-6)


def test_transit_depth_limits():
    nl, nw = 100, 4
    r = np.linspace(7.5e9, 7.0e9, nl)  # cm
    rs = 7.0e10
    # opaque -> (R_top/Rs)^2 ; transparent -> (R_bot/Rs)^2
    opaque = np.asarray(
        transit_depth(jnp.full((nl, nw), 1.0), jnp.asarray(r), rs)
    )
    np.testing.assert_allclose(opaque, (r[0] / rs) ** 2, rtol=1e-3)
    clear = np.asarray(
        transit_depth(jnp.zeros((nl, nw)), jnp.asarray(r), rs)
    )
    np.testing.assert_allclose(clear, (r[-1] / rs) ** 2, rtol=1e-12)


def ref_band_integrate(specwn, spectrum, filterwn, filtertr, star=None, rprs=None):
    """Reference wine.resample + bandintegrate re-derivation
    (code/wine.py:127-199)."""
    idx = np.where((specwn < filterwn[-1]) & (filterwn[0] < specwn))[0]
    x = specwn[idx]
    ifilter = np.interp(x, filterwn, filtertr)
    nifilter = ifilter / np.trapezoid(ifilter, x)
    sig = spectrum[idx]
    if star is not None:
        sig = sig / star[idx] * rprs**2
    return np.trapezoid(sig * nifilter, x)


def test_band_matrix_matches_reference_trapz():
    specwn = np.arange(2500.0, 5001.0, 1.0)
    rng = np.random.default_rng(11)
    spectrum = rng.uniform(0.5, 2.0, len(specwn))
    star = rng.uniform(1e3, 2e3, len(specwn))
    filters = [read_filter(f"{DEMO}/fdemo{i:02d}.dat")
               for i in (1, 5, 10)]

    # transit mode (raw spectrum)
    bm = build_band_matrix(specwn, filters)
    got = np.asarray(band_integrate(bm, jnp.asarray(spectrum)))
    want = [ref_band_integrate(specwn, spectrum, fw, ft) for fw, ft in filters]
    np.testing.assert_allclose(got, want, rtol=1e-10)

    # eclipse mode (star + rprs folded in)
    bm2 = build_band_matrix(specwn, filters, star_flux=star, rprs=0.12)
    got2 = np.asarray(band_integrate(bm2, jnp.asarray(spectrum)))
    want2 = [
        ref_band_integrate(specwn, spectrum, fw, ft, star, 0.12)
        for fw, ft in filters
    ]
    np.testing.assert_allclose(got2, want2, rtol=1e-10)


def test_band_matrix_rejects_uncovered_filter():
    specwn = np.arange(3000.0, 3100.0)
    fw, ft = read_filter(f"{DEMO}/fdemo01.dat")
    with pytest.raises(ValueError, match="does not cover"):
        build_band_matrix(specwn, [(fw, ft)])


# ---------------------------------------------------------------------------
# Full forward model


_DEMO_GRID_CACHE = {}


def make_demo_forward(solution="eclipse", dtype=None, **cfg_kw):
    """Small demo-shaped forward model with synthetic CH4 lines.
    The opacity grid (the expensive part: one XLA compile + build) is
    memoized across tests — it depends on nothing variable."""
    from bart_tpu.io.kurucz import blackbody_star
    from bart_tpu.io.filters import read_filter as rf
    from bart_tpu.utils.grids import pressure_grid

    system = PlanetSystem.from_tep(DEMO_TEP)
    pressure = pressure_grid(40, 1e-5, 100.0)
    wn = np.arange(2500.0, 5001.0, 5.0)
    species = ["H2", "He", "CH4"]
    base_q = np.tile([0.85, 0.149, 1e-3], (40, 1))

    if "grid" not in _DEMO_GRID_CACHE:
        ll = synthetic_linelist("CH4", 2500.0, 5000.0, 2000, seed=12,
                                band_centers=(2700.0, 3100.0, 4300.0))
        t_grid = np.arange(400.0, 3001.0, 200.0)
        _DEMO_GRID_CACHE["grid"] = build_opacity_grid(
            {"CH4": ll}, wn, t_grid, pressure, cond_batch=80,
            dtype=jnp.float64,
        )
    grid = _DEMO_GRID_CACHE["grid"]

    filters = [rf(f"{DEMO}/fdemo{i:02d}.dat")
               for i in range(1, 11)]
    if solution == "eclipse":
        starfl, _ = blackbody_star(wn, system.t_star)
        bands = build_band_matrix(wn, filters, star_flux=starfl,
                                  rprs=system.rprs)
    else:
        bands = build_band_matrix(wn, filters)

    config = ForwardConfig(solution=solution, pt_type="line",
                           molfit=("CH4",), **cfg_kw)
    fm = ForwardModel(
        config,
        wn_grid=wn, pressure=pressure, species=species,
        base_abundances=base_q, opacity=grid, system=system, bands=bands,
        dtype=dtype or jnp.float64,
    )
    return fm


DEMO_PARAMS = np.array([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5])  # demo cfg params


def test_forward_eclipse():
    fm = make_demo_forward("eclipse")
    bandflux, spectrum, valid = fm.jitted()(jnp.asarray(DEMO_PARAMS))
    assert bool(valid)
    assert np.all(np.isfinite(np.asarray(spectrum)))
    bf = np.asarray(bandflux)
    # eclipse depths Fp/Fs*(Rp/Rs)^2: positive, small (<2%)
    assert np.all(bf > 0) and np.all(bf < 0.02)
    # spectral shape: absorption features reduce flux vs continuum
    assert np.asarray(spectrum).std() > 0


def test_forward_transit():
    fm = make_demo_forward("transit")
    # transit: extra radius parameter after the PT block
    params = np.concatenate([DEMO_PARAMS[:5], [fm.r0_km], DEMO_PARAMS[5:]])
    bandflux, spectrum, valid = fm.jitted()(jnp.asarray(params))
    assert bool(valid)
    bf = np.asarray(bandflux)
    rprs2 = (fm.system.r_planet / fm.system.r_star) ** 2
    # depths near (Rp/Rs)^2 ~ 0.0147, slightly above (atmosphere)
    assert np.all(bf > 0.9 * rprs2) and np.all(bf < 1.6 * rprs2)
    # more CH4 -> deeper transit
    params_hi = params.copy()
    params_hi[-1] = 0.5
    bf_hi = np.asarray(fm.jitted()(jnp.asarray(params_hi))[0])
    assert np.all(bf_hi >= bf)


def test_forward_rejections():
    fm = make_demo_forward("eclipse")
    # absurd kappa -> line profile T out of [400, 3000]
    bad = DEMO_PARAMS.copy()
    bad[4] = 3.0  # beta=3 -> T_irr huge -> T > Tmax
    _, _, valid = fm.jitted()(jnp.asarray(bad))
    assert not bool(valid)
    # abundance overflow: 10^3 * 1e-3 = 1.0 > available
    bad2 = DEMO_PARAMS.copy()
    bad2[5] = 3.5
    _, _, valid2 = fm.jitted()(jnp.asarray(bad2))
    assert not bool(valid2)


def test_forward_vmap_batch():
    fm = make_demo_forward("eclipse")
    batch = jnp.asarray(np.tile(DEMO_PARAMS, (8, 1)))
    bandflux, spectrum, valid = fm.batched()(batch)
    assert bandflux.shape == (8, 10)
    assert bool(jnp.all(valid))
    np.testing.assert_allclose(
        np.asarray(bandflux),
        np.broadcast_to(np.asarray(bandflux)[0], (8, 10)),
        rtol=1e-12,
    )


def test_forward_cloud_and_ray():
    fm = make_demo_forward("transit", cloudtop=True, scattering="ray")
    # layout: [5 PT | radius | cloudtop | ray | CH4]
    params = np.concatenate(
        [DEMO_PARAMS[:5], [fm.r0_km], [1e-3], [0.0], DEMO_PARAMS[5:]]
    )
    bf_cloud, _, valid = fm.jitted()(jnp.asarray(params))
    assert bool(valid)
    # high cloud (1e-3 bar) must flatten/raise the transit floor vs deep cloud
    params_deep = params.copy()
    params_deep[6] = 90.0
    bf_deep, _, _ = fm.jitted()(jnp.asarray(params_deep))
    assert np.all(np.asarray(bf_cloud) >= np.asarray(bf_deep) - 1e-12)
    assert float(jnp.min(bf_cloud)) > float(jnp.min(bf_deep))


def test_forward_direct_solution():
    """'direct' geometry: raw emergent flux, no stellar normalization
    (reference makecfg lowers direct->eclipse for transit but BART
    band-integrates the raw spectrum, BARTfunc.py:394-396)."""
    fm = make_demo_forward("direct")
    bf, spectrum, valid = fm.jitted()(jnp.asarray(DEMO_PARAMS))
    assert bool(valid)
    # direct band fluxes are raw fluxes: order pi*B(T~1400K) magnitude
    from bart_tpu.rt.planck import planck_wn

    approx = np.pi * float(planck_wn(jnp.asarray(3000.0), 1420.0))
    assert 0.05 * approx < float(jnp.median(bf)) < 20 * approx


def test_forward_energy_balance_veto():
    # wide Tmax so the veto (not the T-bound check) is what trips
    fm = make_demo_forward("eclipse", ebalance=True, tmax=4000.0)
    # normal params: planet emits less than it receives -> valid
    _, _, valid = fm.jitted()(jnp.asarray(DEMO_PARAMS))
    assert bool(valid)
    # beta = 2.2 -> in-band e_out exceeds e_in -> vetoed while T is
    # still inside [tmin, tmax]
    hot = DEMO_PARAMS.copy()
    hot[4] = 2.2
    _, _, valid_hot = fm.jitted()(jnp.asarray(hot))
    assert not bool(valid_hot)


def test_forward_on_the_fly_matches_fine_grid():
    """Table-free (on-the-fly) opacity path: agrees with a fine-T-grid
    table to interpolation accuracy (the reference's non-gridded mode)."""
    from bart_tpu.io.kurucz import blackbody_star
    from bart_tpu.io.filters import read_filter as rf
    from bart_tpu.opacity.extinction import tile_lines, wing_cutoff, BroadeningSpec
    from bart_tpu.linelist.molecules import get_molecule
    from bart_tpu.utils.grids import pressure_grid
    from bart_tpu import constants as c

    system = PlanetSystem.from_tep(DEMO_TEP)
    pressure = pressure_grid(20, 1e-5, 100.0)
    wn = np.arange(2500.0, 5001.0, 10.0)
    species = ["H2", "He", "CH4"]
    base_q = np.tile([0.85, 0.149, 1e-3], (20, 1))
    ll = synthetic_linelist("CH4", 2500.0, 5000.0, 500, seed=12)

    spec = BroadeningSpec()
    mol = get_molecule("CH4")
    cutoff = wing_cutoff(20.0, 5000.0, 400.0, 1e8, mol.mass * c.AMU,
                         mol.diameter * 1e-8, spec)
    tiles = {"CH4": tile_lines(ll, wn, cutoff, tile_size=64)}

    filters = [rf(f"{DEMO}/fdemo{i:02d}.dat")
               for i in (2, 5, 8)]
    starfl, _ = blackbody_star(wn, system.t_star)
    bands = build_band_matrix(wn, filters, star_flux=starfl, rprs=system.rprs)
    config = ForwardConfig(solution="eclipse", pt_type="line", molfit=("CH4",))

    fm_fly = ForwardModel(
        config, wn_grid=wn, pressure=pressure, species=species,
        base_abundances=base_q, opacity=tiles, system=system, bands=bands,
        dtype=jnp.float64,
    )
    grid = build_opacity_grid({"CH4": ll}, wn,
                              np.arange(400.0, 3001.0, 25.0),  # fine T grid
                              pressure, cond_batch=40, dtype=jnp.float64)
    fm_grid = ForwardModel(
        config, wn_grid=wn, pressure=pressure, species=species,
        base_abundances=base_q, opacity=grid, system=system, bands=bands,
        dtype=jnp.float64,
    )
    p = jnp.asarray(DEMO_PARAMS)
    bf_fly, _, v1 = fm_fly.jitted()(p)
    bf_grid, _, v2 = fm_grid.jitted()(p)
    assert bool(v1) and bool(v2)
    np.testing.assert_allclose(np.asarray(bf_fly), np.asarray(bf_grid),
                               rtol=2e-3)


def test_forward_extended_cloud():
    """cloudrad/cloudext extended gray cloud (reference transit flags
    cloudrad/cloudfct/cloudext, makecfg.py:36-52)."""
    fm0 = make_demo_forward("transit")
    params = np.concatenate([DEMO_PARAMS[:5], [fm0.r0_km], DEMO_PARAMS[5:]])
    bf0 = np.asarray(fm0.jitted()(jnp.asarray(params))[0])

    # a cloud spanning ~the whole modeled radius range with strong
    # extinction must deepen the transit
    rad = np.asarray(
        fm0.diagnostics(jnp.asarray(params))[2]) / 1e5  # km
    fm1 = make_demo_forward(
        "transit", cloudrad=(float(rad.min() + 0.8 * (rad.max()-rad.min())),
                             float(rad.min())), cloudext=1e-4)
    bf1 = np.asarray(fm1.jitted()(jnp.asarray(params))[0])
    assert np.all(bf1 > bf0)

    # zero extinction -> no-op
    fm2 = make_demo_forward(
        "transit", cloudrad=(float(rad.max()), float(rad.min())),
        cloudext=0.0)
    bf2 = np.asarray(fm2.jitted()(jnp.asarray(params))[0])
    np.testing.assert_allclose(bf2, bf0, rtol=1e-12)


# ---------------------------------------------------------------------
# Exponential-sum angular quadrature (rt.eclipse.expsum_weights)


def test_expsum_weights_regenerate_and_beat_raygrid():
    """The hard-coded expsum coefficients reproduce the constrained
    least-squares fit of E3(tau) (regenerated here against scipy), the
    isothermal limit is exact, and every supported order beats the
    reference's 5-angle raygrid against the exact integral."""
    from scipy.special import expn

    from bart_tpu.rt.eclipse import expsum_weights, raygrid_weights

    tau = np.concatenate(
        [np.linspace(0, 5, 8001)[1:], np.geomspace(5, 60, 4000)]
    )
    u = np.exp(-tau)
    truth = expn(3, tau)

    mur, wr = raygrid_weights((0.0, 20.0, 40.0, 60.0, 80.0))
    ray_err = np.max(np.abs(
        np.sum((wr * mur)[:, None] * np.exp(-tau[None, :] / mur[:, None]),
               axis=0) - truth))
    assert 5e-3 < ray_err < 7e-3       # the raygrid-5 error is real

    for n, bound in ((4, 9e-4), (6, 2e-4), (8, 1e-4)):
        mu, w = expsum_weights(n)
        a = w * mu
        # isothermal limit F = pi B: sum a = E3(0) = 1/2 exactly
        np.testing.assert_allclose(a.sum(), 0.5, atol=1e-12)
        S = np.sum(a[:, None] * u[None, :] ** np.arange(1, n + 1)[:, None],
                   axis=0)
        err = np.max(np.abs(S - truth))
        assert err < bound < ray_err

        # regeneration: the constrained lsq fit reproduces the stored
        # coefficients (provenance check)
        A = np.stack([u**m for m in range(1, n + 1)], axis=1)
        A2 = A[:, :-1] - A[:, -1:]
        c, *_ = np.linalg.lstsq(A2, truth - 0.5 * A[:, -1], rcond=None)
        coef = np.concatenate([c, [0.5 - c.sum()]])
        np.testing.assert_allclose(coef, a, rtol=1e-6)

    with pytest.raises(ValueError):
        expsum_weights(5)


def test_expsum_forward_model_beats_raygrid_on_flux():
    """End-to-end eclipse fluxes: quadrature='expsum' is an order of
    magnitude closer to a dense Gauss-Legendre angular integration
    than the reference's raygrid for an optically realistic column."""
    import bart_tpu.rt.fused as fused
    from bart_tpu.rt.eclipse import expsum_weights, raygrid_weights

    rng = np.random.default_rng(0)
    R, L, W = 9, 40, 64
    tab = jnp.asarray(rng.lognormal(-40, 2, (R, L, W)))
    wn = jnp.asarray(np.linspace(2000.0, 2063.0, W))
    wrows = jnp.asarray(rng.lognormal(28, 1, (L, R))) * 3e-5
    T = jnp.asarray(rng.uniform(900.0, 2000.0, (L,)))
    drp = np.abs(rng.normal(2e7, 3e6, (L,)))
    drp[0] = 0.0
    drp = jnp.asarray(drp)

    x, gw = np.polynomial.legendre.leggauss(400)
    truth = fused._single(tab, wn, jnp.asarray(0.5 * (x + 1)),
                          jnp.asarray(0.5 * gw), wrows, T, drp)
    mur, wr = raygrid_weights((0.0, 20.0, 40.0, 60.0, 80.0))
    ray = fused._single(tab, wn, jnp.asarray(mur), jnp.asarray(wr),
                        wrows, T, drp)
    mu, w = expsum_weights(8)
    exs = fused._single(tab, wn, jnp.asarray(mu), jnp.asarray(w),
                        wrows, T, drp, powers=True)
    ray_err = float(jnp.max(jnp.abs(ray / truth - 1)))
    exs_err = float(jnp.max(jnp.abs(exs / truth - 1)))
    assert exs_err < ray_err / 10
    assert exs_err < 2e-3

    # powers (Horner) evaluation == exponential evaluation of the
    # same quadrature
    exs_exp = fused._single(tab, wn, jnp.asarray(mu), jnp.asarray(w),
                            wrows, T, drp, powers=False)
    np.testing.assert_allclose(np.asarray(exs), np.asarray(exs_exp),
                               rtol=1e-6)


def test_expsum_forward_config():
    """ForwardConfig(quadrature='expsum') wires the quadrature and the
    kernels' powers mode through the ForwardModel."""
    fm = make_demo_forward("eclipse", quadrature="expsum", nquad=8)
    assert fm._powers
    assert fm.mu.shape[0] == 8
    bf, spec, ok = fm.jitted()(jnp.asarray(DEMO_PARAMS, fm.dtype))
    assert bool(ok) and bool(jnp.isfinite(spec).all())
    # same model with raygrid agrees at the quadrature-error level
    fm0 = make_demo_forward("eclipse")
    bf0, spec0, _ = fm0.jitted()(jnp.asarray(DEMO_PARAMS, fm0.dtype))
    np.testing.assert_allclose(np.asarray(spec), np.asarray(spec0),
                               rtol=0.05)
