"""Fused forward (rt/fused.py) parity tests.

The eclipse kernel (Pallas through Triton) runs in the Pallas
interpreter here (CPU); compiled for the GPU it is checked by
chip_smoke.py and by the ``gpu``-marked test below.  Reference is the
composable unfused pipeline (opacity.grid.interp_opacity +
opacity.cia/rayleigh/cloud + rt.tau.tau_vertical +
rt.eclipse.eclipse_flux) that golden-tests elsewhere pin to the
reference formulas (SURVEY.md 2.2/3.2).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import bart_tpu.rt.fused as fused
from bart_tpu.rt.eclipse import raygrid_weights


def _problem(M=2, nT=9, L=23, W=300, C=6, seed=7):
    """Random rows-contraction problem in the fused_eclipse contract."""
    rng = np.random.default_rng(seed)
    sigma = jnp.asarray(rng.lognormal(-46, 2, (M, nT, L, W)))
    wn = jnp.asarray(np.linspace(2500, 5000, W))
    mu, muw = raygrid_weights([0.0, 20.0, 40.0, 60.0, 80.0])
    T = jnp.asarray(rng.uniform(500, 2900, (C, L)))
    n_mol = jnp.asarray(rng.lognormal(38, 1, (C, M, L)))
    drp = jnp.asarray(
        np.concatenate(
            [np.zeros((C, 1)), rng.uniform(1e6, 5e6, (C, L - 1))], axis=1
        )
    )
    tab = sigma.reshape(M * nT, L, W)
    w_t = jax.vmap(lambda t: fused.interp_weights(nT, 400.0, 100.0, t))(T)
    nm = jnp.transpose(n_mol, (0, 2, 1))                     # [C, L, M]
    wrows = (nm[:, :, :, None] * w_t[:, :, None, :]).reshape(C, L, M * nT)
    return (tab, wn, jnp.asarray(mu), jnp.asarray(muw), wrows, T, drp,
            sigma, n_mol)


@pytest.fixture
def problem():
    return _problem()


@pytest.fixture
def interpret():
    """Run the eclipse kernel through the Pallas interpreter."""
    old = fused.INTERPRET
    fused.INTERPRET = True
    yield
    fused.INTERPRET = old


def _unfused_reference(tab, wn, mu, muw, wrows, T, drp, sigma, n_mol):
    from bart_tpu.opacity.grid import interp_opacity
    from bart_tpu.rt.eclipse import eclipse_flux
    from bart_tpu.rt.tau import tau_vertical

    n_t = sigma.shape[1]

    def one(T_c, nm_c, drp_c):
        sig = interp_opacity(sigma, 400.0, 100.0, n_t, T_c)
        ext = jnp.einsum("mlw,ml->lw", sig, nm_c,
                         precision=jax.lax.Precision.HIGHEST)
        # reconstruct a radius grid whose segments are drp
        rad = -jnp.cumsum(drp_c)
        tau = tau_vertical(ext, rad)
        return eclipse_flux(tau, T_c, wn, mu, muw)

    return jax.vmap(one)(T, n_mol, drp)


@pytest.mark.slow
def test_single_sample_matches_unfused(problem):
    ref = _unfused_reference(*problem)
    one = fused.fused_eclipse(
        *problem[:4], problem[4][0], problem[5][0], problem[6][0]
    )
    np.testing.assert_allclose(np.asarray(one), np.asarray(ref[0]),
                               rtol=1e-10)


def test_vmap_jnp_path_matches_unfused(problem):
    assert not fused.use_kernel()          # the CPU takes the plain path
    got = jax.vmap(
        lambda w, t, d: fused.fused_eclipse(*problem[:4], w, t, d)
    )(*problem[4:7])
    np.testing.assert_allclose(np.asarray(got), np.asarray(
        _unfused_reference(*problem)), rtol=1e-10)


# The wrapper's padding: chains to the chain block, wn to the tile,
# rows to a power of two >= 16 — each case pads one and not the others
# where the shapes allow (CHAIN_BLOCK 32, WN_TILE 64 by default).
_PAD_CASES = {
    "chains_wn_rows": dict(),                          # C 6, W 300, R 18
    "exact_blocks": dict(M=2, nT=8, W=128, C=32),      # no padding at all
    "chains_only": dict(M=2, nT=8, W=128, C=40),       # 2 chain blocks
    "wn_only": dict(M=2, nT=8, W=200, C=32),
    "rows_only": dict(M=1, nT=27, W=128, C=32),        # R 27 (demo) -> 32
}


@pytest.mark.parametrize("powers", [False, True], ids=["raygrid", "expsum"])
@pytest.mark.parametrize("case", list(_PAD_CASES))
def test_pallas_interpret_matches_unfused(case, powers, interpret):
    from bart_tpu.rt.eclipse import expsum_weights

    prob = _problem(**_PAD_CASES[case])
    tab, wn, mu, muw, wrows, T, drp = prob[:7]
    if powers:
        mu, muw = (jnp.asarray(a) for a in expsum_weights(8))
    got = jax.vmap(lambda w, t, d: fused.fused_eclipse(
        tab, wn, mu, muw, w, t, d, powers=powers))(wrows, T, drp)
    ref = jax.vmap(lambda w, t, d: fused._single(
        tab, wn, mu, muw, w, t, d, powers=powers))(wrows, T, drp)
    if not powers:
        np.testing.assert_allclose(np.asarray(ref), np.asarray(
            _unfused_reference(*prob)), rtol=1e-10)
    assert got.shape == ref.shape == (T.shape[0], wn.shape[0])
    # kernel computes in f32
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=5e-5)


def test_dispatch_rule(monkeypatch):
    """One rule: the kernel on a GPU, the plain path elsewhere, the
    interpreter on request; the vmapped entry traces to the kernel
    exactly when the rule says so."""
    assert fused.use_kernel("gpu") and not fused.use_kernel("cpu")
    monkeypatch.setattr(fused, "INTERPRET", True)
    assert fused.use_kernel("cpu")
    monkeypatch.setattr(fused, "INTERPRET", False)

    tab, wn, mu, muw, wrows, T, drp = _problem()[:7]

    def jaxpr():
        return str(jax.make_jaxpr(jax.vmap(
            lambda w, t, d: fused.fused_eclipse(tab, wn, mu, muw, w, t, d)
        ))(wrows, T, drp))

    assert "pallas_call" not in jaxpr()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert "custom_partitioning" in jaxpr()
    # a batch over the table (not the chain contract) stays plain
    assert "custom_partitioning" not in str(jax.make_jaxpr(jax.vmap(
        lambda tb: fused.fused_eclipse(tb, wn, mu, muw, wrows[0], T[0],
                                       drp[0])))(tab[None]))


def test_kernel_sharded_on_mesh_is_collective_free(interpret):
    """On a (chain, wn) mesh each device runs the kernel on its own
    chain and wn shard: no gathers, same result as unsharded."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    tab, wn, mu, muw, wrows, T, drp = _problem(W=256, C=8)[:7]
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                ("chain", "wn"))

    def put(x, *spec):
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    f = jax.jit(jax.vmap(
        lambda tb, w_n, w, t, d: fused.fused_eclipse(tb, w_n, mu, muw, w,
                                                     t, d),
        in_axes=(None, None, 0, 0, 0)))
    args = (put(tab, None, None, "wn"), put(wn, "wn"), put(wrows, "chain"),
            put(T, "chain"), put(drp, "chain"))
    txt = f.lower(*args).compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute",
               "all-to-all", "reduce-scatter"):
        assert f" {op}(" not in txt and f"{op}-start" not in txt, op
    got = f(*args)
    assert got.sharding.spec == P("chain", "wn")
    ref = jax.vmap(lambda w, t, d: fused._single(tab, wn, mu, muw, w, t, d)
                   )(wrows, T, drp)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=5e-5)


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_on_gpu(monkeypatch):
    """The kernel as compiled for the card == the plain path there
    (chip_smoke.py runs the same comparison at bench width)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel")
    tab, wn, mu, muw, wrows, T, drp = (
        jnp.asarray(a, jnp.float32) for a in _problem(C=40)[:7])
    f = jax.jit(jax.vmap(
        lambda w, t, d: fused.fused_eclipse(tab, wn, mu, muw, w, t, d)))
    got = f(wrows, T, drp)
    monkeypatch.setattr(fused, "use_kernel", lambda backend=None: False)
    ref = jax.jit(jax.vmap(
        lambda w, t, d: fused.fused_eclipse(tab, wn, mu, muw, w, t, d)
    ))(wrows, T, drp)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=5e-5)


@pytest.mark.slow
def test_forward_model_fused_flag_and_parity():
    """The demo-shaped ForwardModel takes the fused path and matches the
    unfused pipeline end-to-end (spectrum + vmapped batch)."""
    import __graft_entry__ as ge

    fm = ge._build_problem(nlayer=12, nwave=256, nlines=300)
    assert fm._fusable
    params = jnp.asarray([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5], fm.dtype)
    band, spec, valid = fm(params)
    assert bool(valid)

    # unfused reference via the diagnostics path
    from bart_tpu.rt.eclipse import eclipse_flux
    from bart_tpu.rt.tau import tau_vertical

    T, q, rad_cm, ext, valid2 = fm.diagnostics(params)
    tau = tau_vertical(ext, rad_cm)
    spec_ref = eclipse_flux(tau, T, fm.wn, fm.mu, fm.mu_w)
    np.testing.assert_allclose(np.asarray(spec), np.asarray(spec_ref),
                               rtol=1e-10)

    # batched (vmapped) evaluation agrees with per-sample
    batch = jnp.stack([params, params * 1.01])
    band_b, spec_b, valid_b = fm.batched()(batch)
    np.testing.assert_allclose(np.asarray(spec_b[0]), np.asarray(spec),
                               rtol=1e-6)


def test_forward_model_fused_full_continuum():
    """CIA + fitted Rayleigh + cloud deck all fold into the fused rows
    contraction and match the unfused ops exactly (the WASP-12b-class
    configuration; reference csfile/scattering/cloudtop flags)."""
    import __graft_entry__ as ge
    from bart_tpu.opacity.cia import CiaTable
    from bart_tpu.rt.eclipse import eclipse_flux
    from bart_tpu.rt.forward import ForwardConfig, ForwardModel
    from bart_tpu.rt.tau import tau_vertical

    base = ge._build_problem(nlayer=12, nwave=256, nlines=300)
    wn = np.asarray(base.wn, np.float64)
    cia = CiaTable(
        ("H2", "H2"),
        temps=np.array([300.0, 900.0, 1700.0, 2600.0, 3500.0]),
        wn=np.linspace(wn[0] - 100, wn[-1] + 100, 40),
        absorption=np.abs(
            np.random.default_rng(3).normal(1e-7, 3e-8, (5, 40))
        ),
    )
    cfg = ForwardConfig(
        solution="eclipse", pt_type="line", molfit=("CH4",),
        cloudtop=True, scattering="ray",
    )
    fm = ForwardModel(
        cfg,
        wn_grid=wn,
        pressure=np.asarray(base.pressure, np.float64),
        species=base.species,
        base_abundances=np.asarray(base.tables["base_q"], np.float64),
        opacity=base.opacity,
        system=base.system,
        bands=base.bands,
        cia_tables=[cia],
        dtype=base.dtype,
    )
    assert fm._fusable and "frows" in fm.tables
    # params: 5 PT + cloudtop + rayleigh + CH4
    params = jnp.asarray(
        [-2.0, 0.0, 1.0, 0.0, 0.98, 0.05, 0.3, -0.5], fm.dtype
    )
    band, spec, valid = fm(params)
    assert bool(valid)

    T, q, rad_cm, ext, _ = fm.diagnostics(params)
    tau = tau_vertical(ext, rad_cm)
    spec_ref = eclipse_flux(tau, T, fm.wn, fm.mu, fm.mu_w)
    np.testing.assert_allclose(np.asarray(spec), np.asarray(spec_ref),
                               rtol=1e-8)


# ---------------------------------------------------------------------
# fused_transit (slant geometry)


@pytest.fixture
def tproblem(problem):
    """Transit-geometry problem reusing the eclipse fixture's extinction
    rows, plus descending radii per chain."""
    tab, wn, mu, muw, wrows, T, drp = problem[:7]
    C, L = T.shape
    rng = np.random.default_rng(11)
    # descending radii ~ 1 R_jup with 30-80 km layer spacings
    dr = rng.uniform(3e6, 8e6, (C, L))
    rad = 7.1e9 - np.cumsum(dr, axis=1)
    return tab, wrows, jnp.asarray(rad), wn


def _unfused_transit_reference(tab, wrows, rad, wn):
    from bart_tpu.rt.transit_geom import transit_depth

    def one(w_c, r_c):
        ext = jnp.einsum("lr,rlw->lw", w_c, tab,
                         precision=jax.lax.Precision.HIGHEST)
        return transit_depth(ext, r_c, 6.96e10)

    return jax.vmap(one)(wrows, rad)


def _fused_transit_batch(tab, wrows, rad, wn):
    from bart_tpu.rt.transit_geom import slant_geometry

    def one(w_c, r_c):
        G, wgt = slant_geometry(r_c)
        out = fused.fused_transit(tab, w_c, G, wgt)
        return (r_c[-1] ** 2 + out) / 6.96e10**2

    return jax.vmap(one)(wrows, rad)


def test_transit_single_sample_matches_unfused(tproblem):
    from bart_tpu.rt.transit_geom import slant_geometry

    tab, wrows, rad, wn = tproblem
    ref = _unfused_transit_reference(tab, wrows, rad, wn)
    G, wgt = slant_geometry(rad[0])
    out = fused.fused_transit(tab, wrows[0], G, wgt)
    one = (rad[0, -1] ** 2 + out) / 6.96e10**2
    np.testing.assert_allclose(np.asarray(one), np.asarray(ref[0]),
                               rtol=1e-9)


def test_transit_vmap_jnp_path_matches_unfused(tproblem):
    got = _fused_transit_batch(*tproblem)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(_unfused_transit_reference(*tproblem)),
        rtol=1e-9,
    )


# ---------------------------------------------------------------------
# Folded rtosamp (fused_eclipse_folded / fused_transit_folded): outputs
# are per-bin means of the fine spectrum (average AFTER exp —
# docs/LINE_SAMPLING.md), accumulated one sub-sample at a time.


@pytest.fixture
def fproblem(problem):
    """Folded version of the eclipse fixture: K=4 sub-samples whose
    k-slices are perturbed copies of the base table (so in-bin
    structure exists), plus the matching fine-layout table."""
    tab, wn, mu, muw, wrows, T, drp = problem[:7]
    K = 4
    rng = np.random.default_rng(5)
    R, L, W = tab.shape
    fine = jnp.asarray(
        np.asarray(tab)[:, :, :, None]
        * rng.lognormal(0.0, 0.5, (R, L, W, K))
    ).reshape(R, L, W * K)
    tabk = fused.fold_table(fine, K)
    return tabk, fine, wn, mu, muw, wrows, T, drp, K


def _fine_then_average(fine, wn, mu, muw, wrows, T, drp, K):
    """Truth: the plain fused path on every fine point (with fine-wn
    Planck), spectrum averaged per bin."""
    W = wn.shape[0]
    d = wn[1] - wn[0]
    off = d * ((jnp.arange(K) + 0.5) / K - 0.5)
    wn_fine = (wn[:, None] + off[None, :]).reshape(-1)

    def one(w_c, T_c, d_c):
        s = fused._single(fine, wn_fine, mu, muw, w_c, T_c, d_c)
        return s.reshape(W, K).mean(axis=1)

    return jax.vmap(one)(wrows, T, drp)


def test_folded_eclipse_jnp_matches_fine_average(fproblem):
    """fused_eclipse_folded == fine-grid evaluation + bin average, up to the
    bin-center-Planck approximation (~(wndelt/wn)^2 class, far below
    f32 resolution of the flux here)."""
    tabk, fine, wn, mu, muw, wrows, T, drp, K = fproblem
    ref = _fine_then_average(fine, wn, mu, muw, wrows, T, drp, K)
    got = jax.vmap(
        lambda w, t, d: fused.fused_eclipse_folded(tabk, wn, mu, muw, w,
                                                   t, d)
    )(wrows, T, drp)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4)


def test_powers_kernels_match_jnp(fproblem, interpret):
    """expsum powers mode (Horner attenuation): the eclipse kernel in
    the interpreter == the jnp path on the fine grid, and the folded
    form == the fine-grid bin average."""
    from bart_tpu.rt.eclipse import expsum_weights

    tabk, fine, wn_out, _, _, wrows, T, drp, K = fproblem
    mu, muw = expsum_weights(8)
    mu, muw = jnp.asarray(mu), jnp.asarray(muw)
    W = wn_out.shape[0]
    d = wn_out[1] - wn_out[0]
    off = d * ((jnp.arange(K) + 0.5) / K - 0.5)
    wn_fine = (wn_out[:, None] + off[None, :]).reshape(-1)

    ref = jax.vmap(lambda w, t, d: fused._single(
        fine, wn_fine, mu, muw, w, t, d, powers=True))(wrows, T, drp)
    got = jax.vmap(lambda w, t, d: fused.fused_eclipse(
        fine, wn_fine, mu, muw, w, t, d, powers=True))(wrows, T, drp)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=5e-5)

    folded = jax.vmap(lambda w, t, d: fused.fused_eclipse_folded(
        tabk, wn_out, mu, muw, w, t, d, powers=True))(wrows, T, drp)
    np.testing.assert_allclose(
        np.asarray(folded), np.asarray(ref).reshape(-1, W, K).mean(-1),
        rtol=2e-4)


def test_folded_transit_jnp_matches_fine_average(fproblem, tproblem):
    """Transit folding is algebraically exact (no Planck): folded ==
    fine + bin-average to rounding."""
    from bart_tpu.rt.transit_geom import slant_geometry

    tabk, fine, wn, mu, muw, wrows, T, drp, K = fproblem
    rad = tproblem[2]
    W = wn.shape[0]

    def ref_one(w_c, r_c):
        G, wgt = slant_geometry(r_c)
        s = fused.fused_transit(fine, w_c, G, wgt)
        return s.reshape(W, K).mean(axis=1)

    def fold_one(w_c, r_c):
        G, wgt = slant_geometry(r_c)
        return fused.fused_transit_folded(tabk, w_c, G, wgt)

    ref = jax.vmap(ref_one)(wrows, rad)
    got = jax.vmap(fold_one)(wrows, rad)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-6)


def test_forward_model_folded_matches_fine_pipeline():
    """ForwardModel(fold_osamp=K) == the plain model run on the folded
    fine grid with its spectrum bin-averaged, for BOTH geometries with
    CIA + Rayleigh rows folded in (the rt.forward wiring test)."""
    from bart_tpu.io.kurucz import blackbody_star
    from bart_tpu.io.tep import PlanetSystem
    from bart_tpu.linelist.tli import synthetic_linelist
    from bart_tpu.obs.bands import build_band_matrix
    from bart_tpu.opacity.cia import CiaTable
    from bart_tpu.opacity.grid import build_opacity_grid
    from bart_tpu.rt.forward import ForwardConfig, ForwardModel
    from bart_tpu.utils.grids import (
        folded_fine_grid, pressure_grid, wavenumber_grid,
    )

    K = 4
    pressure = pressure_grid(16, 1e-5, 100.0)
    wn_out = wavenumber_grid(wnlow=2500.0, wnhigh=2563.0, wndelt=1.0)
    wn_fine = folded_fine_grid(wn_out, K)
    system = PlanetSystem(6075.0, 7.97e8, 4.37, 7.05e9, 9.44e7, 1.32e27)
    # clustered list with a line-free region (beyond the nwidth wing
    # cutoff) so the adaptive fine/smooth split activates
    lines = synthetic_linelist("CH4", 2495.0, 2515.0, 60, seed=3,
                               band_centers=(2505.0,))
    grid = build_opacity_grid(
        {"CH4": lines}, wn_fine, np.arange(400.0, 3001.0, 650.0),
        pressure, nwidth=5.0,
    )
    temps = np.arange(400.0, 3001.0, 400.0)
    cwn = np.linspace(2000.0, 3000.0, 60)
    cia = CiaTable(("H2", "H2"), temps, cwn,
                   1e-7 * (temps[:, None] / 1000.0) ** 1.5
                   * np.ones((len(temps), 60)))
    centers = np.linspace(wn_out[6], wn_out[-7], 4)
    filters = [(np.linspace(c - 6, c + 6, 25), np.ones(25))
               for c in centers]
    sp = ["H2", "He", "CH4"]
    q0 = np.tile([0.85, 0.149, 1e-3], (len(pressure), 1))

    for sol in ("eclipse", "transit"):
        if sol == "eclipse":
            sf_out, _ = blackbody_star(wn_out, system.t_star)
            sf_fine, _ = blackbody_star(wn_fine, system.t_star)
            b_out = build_band_matrix(wn_out, filters, star_flux=sf_out,
                                      rprs=system.rprs)
            b_fine = build_band_matrix(wn_fine, filters, star_flux=sf_fine,
                                       rprs=system.rprs)
        else:
            b_out = build_band_matrix(wn_out, filters)
            b_fine = build_band_matrix(wn_fine, filters)
        fc = ForwardConfig(solution=sol, pt_type="line", molfit=("CH4",),
                           scattering="ray")
        kw = dict(pressure=pressure, species=sp, base_abundances=q0,
                  opacity=grid, system=system, cia_tables=[cia])
        fm_fold = ForwardModel(fc, wn_grid=wn_out, bands=b_out,
                               fold_osamp=K, fold_adapt=None, **kw)
        fm_fine = ForwardModel(fc, wn_grid=wn_fine, bands=b_fine, **kw)
        assert "sigmak" in fm_fold.tables and "frowsk" in fm_fold.tables
        p = [-2.0, 0.0, 1.0, 0.0, 0.98]
        if sol == "transit":
            p.append(system.r_planet / 1000.0)
        p = jnp.asarray(p + [-1.0, -0.5], fm_fold.dtype)
        bf1, s1, ok1 = fm_fold.jitted()(p)
        bf2, s2, ok2 = fm_fine.jitted()(p)
        assert bool(ok1) and bool(ok2)
        s2bar = np.asarray(s2).reshape(-1, K).mean(axis=1)
        np.testing.assert_allclose(np.asarray(s1), s2bar, rtol=1e-4)
        # batched folded path stays finite and consistent
        batch = jnp.stack([p, p])
        bf_b, s_b, ok_b = fm_fold.batched()(batch)
        np.testing.assert_allclose(np.asarray(s_b[0]), np.asarray(s1),
                                   rtol=1e-6)

        # static adaptive split (fold_adapt): only structured bins pay
        # K sub-samples; result stays within the rtosamp error class
        fm_ad = ForwardModel(fc, wn_grid=wn_out, bands=b_out,
                             fold_osamp=K, fold_adapt=0.02, **kw)
        assert fm_ad._idx_fine is not None, "demo table should split"
        assert "sigmas" in fm_ad.tables and "frowss" in fm_ad.tables
        n_f, n_s = len(fm_ad._idx_fine), len(fm_ad._idx_smooth)
        assert n_f + n_s == len(wn_out) and n_s > 0
        bf3, s3, ok3 = fm_ad.jitted()(p)
        assert bool(ok3)
        np.testing.assert_allclose(np.asarray(s3), np.asarray(s1),
                                   rtol=3e-4)
        # fine bins are numerically identical to the full-fold model
        np.testing.assert_allclose(np.asarray(s3)[fm_ad._idx_fine],
                                   np.asarray(s1)[fm_ad._idx_fine],
                                   rtol=1e-6)


def test_forward_model_fused_transit_parity():
    """A transit-geometry ForwardModel takes the fused path and matches
    the unfused slant pipeline end-to-end."""
    import __graft_entry__ as ge
    from bart_tpu.rt.forward import ForwardConfig, ForwardModel
    from bart_tpu.rt.transit_geom import transit_depth

    base = ge._build_problem(nlayer=12, nwave=256, nlines=300)
    cfg = ForwardConfig(solution="transit", pt_type="line",
                        molfit=("CH4",))
    fm = ForwardModel(
        cfg,
        wn_grid=np.asarray(base.wn, np.float64),
        pressure=np.asarray(base.pressure, np.float64),
        species=base.species,
        base_abundances=np.asarray(base.tables["base_q"], np.float64),
        opacity=base.opacity,
        system=base.system,
        bands=base.bands,
        dtype=base.dtype,
    )
    assert fm._fusable
    # params: 5 PT + radius + CH4
    r0 = fm.r0_km
    params = jnp.asarray([-2.0, 0.0, 1.0, 0.0, 0.98, r0, -0.5], fm.dtype)
    band, spec, valid = fm(params)
    assert bool(valid)

    T, q, rad_cm, ext, _ = fm.diagnostics(params)
    spec_ref = transit_depth(ext, rad_cm, fm.system.r_star * 100.0)
    # both paths are f32 with different (mathematically identical)
    # operation orders — rounding-level agreement, not bitwise
    np.testing.assert_allclose(np.asarray(spec), np.asarray(spec_ref),
                               rtol=1e-5)

    # batched (jitted + vmapped) evaluation agrees with per-sample —
    # this is the regression guard for the fma/cancellation bug in the
    # old r^2 - b^2 slant chords (jit vs eager diverged by 1.7e-2;
    # the anchored-delta form in rt.tau.slant_chords keeps it ~1e-7)
    batch = jnp.stack([params, params])
    band_b, spec_b, valid_b = fm.batched()(batch)
    np.testing.assert_allclose(np.asarray(spec_b[0]), np.asarray(spec),
                               rtol=1e-6)


def test_forward_model_fold_bf16_tables():
    """fold_bf16 stores the fine tables in bfloat16 (the production
    memory/upload knob) and changes band fluxes only at the level of
    bf16 table rounding (the table is widened to f32 per sub-sample,
    so the contraction itself stays f32).  Bound measured on CPU."""
    from bart_tpu.io.kurucz import blackbody_star
    from bart_tpu.io.tep import PlanetSystem
    from bart_tpu.linelist.tli import synthetic_linelist
    from bart_tpu.obs.bands import build_band_matrix
    from bart_tpu.opacity.grid import build_opacity_grid
    from bart_tpu.rt.forward import ForwardConfig, ForwardModel
    from bart_tpu.utils.grids import folded_fine_grid, pressure_grid, \
        wavenumber_grid

    K = 4
    pressure = pressure_grid(12, 1e-5, 100.0)
    wn_out = wavenumber_grid(wnlow=2500.0, wnhigh=2563.0, wndelt=1.0)
    wn_fine = folded_fine_grid(wn_out, K)
    system = PlanetSystem(6075.0, 7.97e8, 4.37, 7.05e9, 9.44e7, 1.32e27)
    lines = synthetic_linelist("CH4", 2495.0, 2560.0, 80, seed=5)
    grid = build_opacity_grid(
        {"CH4": lines}, wn_fine, np.arange(400.0, 3001.0, 650.0),
        pressure, nwidth=5.0,
    )
    centers = np.linspace(wn_out[6], wn_out[-7], 4)
    filters = [(np.linspace(c - 6, c + 6, 25), np.ones(25))
               for c in centers]
    sp = ["H2", "He", "CH4"]
    q0 = np.tile([0.85, 0.149, 1e-3], (len(pressure), 1))
    sf_out, _ = blackbody_star(wn_out, system.t_star)
    b_out = build_band_matrix(wn_out, filters, star_flux=sf_out,
                              rprs=system.rprs)
    fc = ForwardConfig(solution="eclipse", pt_type="line", molfit=("CH4",))
    kw = dict(pressure=pressure, species=sp, base_abundances=q0,
              opacity=grid, system=system, wn_grid=wn_out, bands=b_out,
              fold_osamp=K, fold_adapt=None)
    fm32 = ForwardModel(fc, **kw)
    fm16 = ForwardModel(fc, fold_bf16=True, **kw)
    assert fm16.tables["sigmak"].dtype == jnp.bfloat16
    assert fm32.tables["sigmak"].dtype == jnp.float32
    # half the bytes on the fine table
    assert fm16.tables["sigmak"].nbytes * 2 == fm32.tables["sigmak"].nbytes

    p = jnp.asarray([-2.0, 0.0, 1.0, 0.0, 0.98, -1.0], fm32.dtype)
    bf32, s32, ok32 = fm32.jitted()(p)
    bf16, s16, ok16 = fm16.jitted()(p)
    assert bool(ok32) and bool(ok16)
    # band fluxes: bf16 table rounding integrates out (measured
    # ~2e-4 max here); spectra carry the pointwise rounding
    np.testing.assert_allclose(np.asarray(bf16), np.asarray(bf32),
                               rtol=2e-3)
    np.testing.assert_allclose(np.asarray(s16), np.asarray(s32),
                               rtol=3e-2)

    # config plumbing: the foldtable16 key parses
    from bart_tpu.driver.config import load_config
    import os as _os

    demo = _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), "examples", "demo_eclipse.cfg")
    cfg = load_config(demo, {"foldtable16": "True", "rtosamp": "4"})
    assert cfg.foldtable16 is True


def test_fold_bf16_with_adaptive_split():
    """fold_bf16 + fold_adapt combine: fine tables (sigmak/frowsk) go
    bf16, smooth bin-mean tables (sigmas/frowss) STAY f32 (they feed
    the K=1 HIGHEST-precision path), and the forward model runs — the
    combination of the accuracy-mode WASP config."""
    from bart_tpu.io.kurucz import blackbody_star
    from bart_tpu.io.tep import PlanetSystem
    from bart_tpu.linelist.tli import synthetic_linelist
    from bart_tpu.obs.bands import build_band_matrix
    from bart_tpu.opacity.cia import CiaTable
    from bart_tpu.opacity.grid import build_opacity_grid
    from bart_tpu.rt.forward import ForwardConfig, ForwardModel
    from bart_tpu.utils.grids import folded_fine_grid, pressure_grid, \
        wavenumber_grid

    K = 4
    pressure = pressure_grid(12, 1e-5, 100.0)
    wn_out = wavenumber_grid(wnlow=2500.0, wnhigh=2563.0, wndelt=1.0)
    wn_fine = folded_fine_grid(wn_out, K)
    system = PlanetSystem(6075.0, 7.97e8, 4.37, 7.05e9, 9.44e7, 1.32e27)
    # clustered lines -> some smooth bins survive for the split
    lines = synthetic_linelist("CH4", 2495.0, 2515.0, 60, seed=3,
                               band_centers=(2505.0,))
    grid = build_opacity_grid(
        {"CH4": lines}, wn_fine, np.arange(400.0, 3001.0, 650.0),
        pressure, nwidth=5.0,
    )
    temps = np.arange(400.0, 3001.0, 400.0)
    cwn = np.linspace(2000.0, 3000.0, 60)
    cia = CiaTable(("H2", "H2"), temps, cwn,
                   1e-7 * (temps[:, None] / 1000.0) ** 1.5
                   * np.ones((len(temps), 60)))
    centers = np.linspace(wn_out[6], wn_out[-7], 4)
    filters = [(np.linspace(c - 6, c + 6, 25), np.ones(25))
               for c in centers]
    sp = ["H2", "He", "CH4"]
    q0 = np.tile([0.85, 0.149, 1e-3], (len(pressure), 1))
    sf_out, _ = blackbody_star(wn_out, system.t_star)
    b_out = build_band_matrix(wn_out, filters, star_flux=sf_out,
                              rprs=system.rprs)
    fc = ForwardConfig(solution="eclipse", pt_type="line", molfit=("CH4",))
    kw = dict(pressure=pressure, species=sp, base_abundances=q0,
              opacity=grid, system=system, wn_grid=wn_out, bands=b_out,
              cia_tables=[cia], fold_osamp=K, fold_adapt=0.02)
    fm16 = ForwardModel(fc, fold_bf16=True, **kw)
    t = fm16.tables
    assert fm16._idx_fine is not None, "split did not activate"
    assert t["sigmak"].dtype == jnp.bfloat16
    assert t["frowsk"].dtype == jnp.bfloat16
    assert t["sigmas"].dtype == jnp.float32
    assert t["frowss"].dtype == jnp.float32

    fm32 = ForwardModel(fc, **kw)
    p = jnp.asarray([-2.0, 0.0, 1.0, 0.0, 0.98, -1.0], fm32.dtype)
    bf16_, s16, ok16 = fm16.jitted()(p)
    bf32_, s32, ok32 = fm32.jitted()(p)
    assert bool(ok16) and bool(ok32)
    np.testing.assert_allclose(np.asarray(bf16_), np.asarray(bf32_),
                               rtol=2e-3)
    # smooth bins are untouched by the bf16 fine tables
    sm = fm16._idx_smooth
    np.testing.assert_allclose(np.asarray(s16)[sm], np.asarray(s32)[sm],
                               rtol=1e-6)
