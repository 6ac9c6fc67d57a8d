"""Tests for grids, TEP/filter/abundance/atm I/O, stoichiometry, hydrostatics."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from bart_tpu.io.abundances import read_elements, scale_abundances, write_elements
from bart_tpu.io.atm import Atmosphere, read_atm, write_atm_tea, write_atm_transit
from bart_tpu.io.filters import read_filter
from bart_tpu.io.tep import PlanetSystem, TepFile
from bart_tpu.physics import stoich
from bart_tpu.physics.hydro import radius_profile
from bart_tpu.utils import grids

# assumed demo inputs in the repository (examples/make_demo_inputs.py)
DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "examples", "demo_inputs")


def test_pressure_grid_roundtrip(tmp_path):
    p = grids.pressure_grid(100, 1e-5, 100.0, log=True)
    assert p[0] == pytest.approx(1e-5) and p[-1] == pytest.approx(100.0)
    assert np.allclose(np.diff(np.log10(p)), np.log10(p[1] / p[0]))
    f = tmp_path / "t.pres"
    grids.write_pressure_file(p, str(f))
    np.testing.assert_allclose(grids.read_pressure_file(str(f)), p, rtol=1e-4)


def test_wavenumber_grid_demo():
    # demo config: wllow 2.0 um, wlhigh 4.0 um, wndelt 1.0
    wn = grids.wavenumber_grid(wllow=2.0, wlhigh=4.0, wlfct=1e-4, wndelt=1.0)
    assert wn[0] == pytest.approx(2500.0)
    assert wn[-1] == pytest.approx(5000.0)
    assert len(wn) == 2501


def test_tep_reader():
    tep = TepFile(f"{DEMO}/demo_system.tep")
    assert tep.getfloat("Ts") == pytest.approx(6075.0)
    assert tep.getfloat("Rs") == pytest.approx(7.97e8 / 6.96e8, rel=1e-12)
    assert tep.getvalue("planetname") == "demo-b"
    sys = PlanetSystem.from_tep(f"{DEMO}/demo_system.tep")
    # the unit conversions invert the ones the file was written with
    np.testing.assert_allclose(
        [sys.t_star, sys.r_star, sys.logg_star, sys.sma, sys.r_planet,
         sys.m_planet],
        [6075.0, 7.97e8, 4.37, 7.05e9, 9.44e7, 1.32e27], rtol=1e-12)
    assert 500 < sys.teff_planet < 3000
    assert 500 < sys.g_planet_cgs < 5000  # HD209458b-like ~ 980 cm/s2
    assert sys.rprs == pytest.approx(
        sys.r_planet / (tep.getfloat("Rs") * 6.96e8), rel=1e-12
    )


def test_filter_reader():
    wn, tr = read_filter(f"{DEMO}/fdemo01.dat")
    assert np.all(np.diff(wn) > 0)
    assert tr.max() == pytest.approx(1.0)
    # fdemo01: 2540-2660 cm-1 top-hat, stored in microns (wavelength
    # descending as wn ascends) and returned on ascending wn
    assert wn[0] == pytest.approx(2540.0, rel=1e-12)
    assert wn[-1] == pytest.approx(2660.0, rel=1e-12)


def test_abundances_scale_swap(tmp_path):
    t = read_elements(f"{DEMO}/abundances_Asplund2009.txt")
    assert t.dex_of("H") == pytest.approx(12.0)
    assert t.mass_of("He") == pytest.approx(4.002602)

    t10 = scale_abundances(t, solar_times=10.0)
    assert t10.dex_of("C") == pytest.approx(t.dex_of("C") + 1.0)
    assert t10.dex_of("H") == pytest.approx(12.0)  # H unchanged

    tswap = scale_abundances(t, co_swap=True)
    assert tswap.dex_of("C") == pytest.approx(t.dex_of("O"))
    assert tswap.dex_of("O") == pytest.approx(t.dex_of("C"))

    out = tmp_path / "abn.txt"
    write_elements(t10, str(out))
    t2 = read_elements(str(out))
    np.testing.assert_allclose(t2.mass, t.mass, rtol=1e-6)


def test_stoich():
    assert stoich.parse_formula("H2O") == {"H": 2, "O": 1}
    assert stoich.parse_formula("CH4") == {"C": 1, "H": 4}
    assert stoich.parse_formula("ClSSCl") == {"Cl": 2, "S": 2}
    assert stoich.parse_formula("H-") == {"H": 1, "e": 1}
    assert stoich.parse_formula("Na+") == {"Na": 1, "e": -1}
    assert stoich.strip_janaf("H2O_g") == "H2O"
    assert stoich.strip_janaf("He_ref") == "He"
    assert stoich.strip_janaf("H_ion_p") == "H+"

    t = read_elements(f"{DEMO}/abundances_Asplund2009.txt")
    assert stoich.species_mass("H2O", t) == pytest.approx(2 * 1.008 + 15.999)
    # mean molar mass of an 85/15 H2/He mix:
    mu = stoich.mean_molar_mass(
        ["H2", "He"], np.array([[0.85, 0.15]]), t
    )
    assert mu[0] == pytest.approx(0.85 * 2.016 + 0.15 * 4.002602)


def test_atm_roundtrip(tmp_path):
    p = grids.pressure_grid(20, 1e-5, 100.0)
    atm = Atmosphere(
        species=["H2", "He", "CH4"],
        pressure=p,
        temperature=np.linspace(900, 1500, 20),
        abundances=np.tile([0.85, 0.149, 1e-3], (20, 1)),
        radius=np.linspace(75000, 70000, 20),
    )
    f1 = tmp_path / "a.atm"
    write_atm_tea(atm, str(f1))
    back = read_atm(str(f1))
    assert back.species == atm.species
    np.testing.assert_allclose(back.pressure, atm.pressure, rtol=1e-4)
    np.testing.assert_allclose(back.temperature, atm.temperature, atol=0.01)
    np.testing.assert_allclose(back.abundances, atm.abundances, rtol=1e-4)

    f2 = tmp_path / "b.atm"
    write_atm_transit(atm, str(f2))
    back2 = read_atm(str(f2))  # bottom-first on disk, top-first in memory
    np.testing.assert_allclose(back2.pressure, atm.pressure, rtol=1e-4)
    np.testing.assert_allclose(back2.radius, atm.radius, atol=0.01)


def ref_radpress(pressure, temperature, mu, p0, R0, g0):
    """Reference hydrostatic integration, transcribed from
    code/makeatm.py:183-263 (numpy, descending-press internal order)."""
    import scipy.constants as sc
    from scipy.interpolate import interp1d

    n = len(pressure)
    rad = np.zeros(n)
    g = np.zeros(n)
    interPT = interp1d(np.log10(pressure), temperature)
    intermu = interp1d(np.log10(pressure), mu)
    temp0 = interPT(np.log10(p0))
    mu0 = intermu(np.log10(p0))
    press = pressure[::-1]
    temp = temperature[::-1]
    m = mu[::-1]
    idx = np.argmin(np.abs(press - p0))
    if press[idx] != p0:
        if press[idx] > p0:
            rad[idx] = R0 + 0.5 * (temp[idx] / m[idx] + temp0 / mu0) * (
                sc.Avogadro * sc.k * np.log(p0 / press[idx]) / g0
            )
        else:
            rad[idx] = R0 - 0.5 * (temp[idx] / m[idx] + temp0 / mu0) * (
                sc.Avogadro * sc.k * np.log(press[idx] / p0) / g0
            )
        g[idx] = g0 * R0**2 / rad[idx] ** 2
    else:
        rad[idx] = R0
        g[idx] = g0
    for i in reversed(np.arange(idx)):
        rad[i] = rad[i + 1] - 0.5 * (temp[i] / m[i] + temp[i + 1] / m[i + 1]) * (
            sc.Avogadro * sc.k * np.log(press[i] / press[i + 1]) / g[i + 1]
        )
        g[i] = g[i + 1] * rad[i + 1] ** 2 / rad[i] ** 2
    for i in np.arange(idx + 1, n):
        rad[i] = rad[i - 1] + 0.5 * (temp[i] / m[i] + temp[i - 1] / m[i - 1]) * (
            sc.Avogadro * sc.k * np.log(press[i - 1] / press[i]) / g[i - 1]
        )
        g[i] = g[i - 1] * rad[i - 1] ** 2 / rad[i] ** 2
    return rad[::-1]


def test_radius_profile_matches_reference():
    p = grids.pressure_grid(100, 1e-5, 100.0)
    T = np.linspace(900.0, 1700.0, 100)
    mu = np.full(100, 2.3)
    p0, R0, g0 = 0.1, 71492.0, 9.36  # km, m/s2

    want = ref_radpress(p, T, mu, p0, R0, g0)
    got = np.asarray(
        radius_profile(jnp.asarray(p), jnp.asarray(T), jnp.asarray(mu), p0, R0, g0)
    )
    np.testing.assert_allclose(got, want, rtol=1e-10)
    # radius decreases with pressure (top-first ordering):
    assert np.all(np.diff(got) < 0)


def test_radius_profile_anchor_on_grid():
    p = grids.pressure_grid(50, 1e-3, 100.0)
    T = np.full(50, 1200.0)
    mu = np.full(50, 2.3)
    p0 = float(p[25])
    want = ref_radpress(p, T, mu, p0, 70000.0, 9.0)
    got = np.asarray(
        radius_profile(jnp.asarray(p), jnp.asarray(T), jnp.asarray(mu), p0, 70000.0, 9.0)
    )
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_kurucz_pck_parser(tmp_path):
    """Synthetic .pck grid in the reference-documented format
    (code/kurucz_inten.py:160-317)."""
    from bart_tpu.io.kurucz import blackbody_star, read_kurucz_pck, stellar_flux

    nw = 8
    waves_nm = np.array([500.0, 800.0, 1200.0, 1700.0, 2300.0, 3000.0,
                         3800.0, 4700.0])
    lines = ["SOME HEADER", "END"]
    lines.append("".join(f"{w:10.2f}" for w in waves_nm))
    models = [(5750.0, 4.0), (5750.0, 4.5), (6000.0, 4.0), (6000.0, 4.5)]
    fluxes = {}
    for i, (t, g) in enumerate(models):
        lines.append(f"TEFF {t:7.0f}  GRAVITY {g:7.5f} MODEL")
        f1 = (i + 1) * np.arange(1, nw + 1, dtype=float)
        fluxes[(t, g)] = f1
        lines.append("".join(f"{v:10.3E}" for v in f1))   # inten
        lines.append("".join(f"{v:10.3E}" for v in f1 * 0.5))  # nainten
    path = tmp_path / "grid.pck"
    path.write_text("\n".join(lines) + "\n")

    grid = read_kurucz_pck(str(path))
    assert grid.inten.shape == (4, nw)
    np.testing.assert_allclose(grid.temp, [5750, 5750, 6000, 6000])
    np.testing.assert_allclose(grid.wave_m, waves_nm * 1e-9)
    # x4 Eddington, x1e-3 cgs->MKS:
    np.testing.assert_allclose(grid.inten[0], fluxes[(5750.0, 4.0)] * 4e-3,
                               rtol=1e-5)

    # nearest-model selection (reference wine.readkurucz semantics)
    fl, wn, tmod, gmod = stellar_flux(grid, 5800.0, 4.1)
    assert tmod == 5750.0 and gmod == 4.0
    assert np.all(np.diff(wn) > 0)
    # interp mode runs and lands between bracket models
    fl2, _, _, _ = stellar_flux(grid, 5875.0, 4.25, mode="interp")
    assert np.all(fl2 > 0)

    # spline mode (reference kurucz_inten.interp equivalent): exact at
    # the grid nodes, positive between them
    fl3, _, _, _ = stellar_flux(grid, 6000.0, 4.5, mode="spline")
    fl_node, _, _, _ = stellar_flux(grid, 6000.0, 4.5, mode="nearest")
    np.testing.assert_allclose(fl3, fl_node, rtol=1e-8)
    fl4, _, _, _ = stellar_flux(grid, 5900.0, 4.2, mode="spline")
    assert np.all(fl4 > 0)
    lo = np.minimum(fl_node, stellar_flux(grid, 5750.0, 4.0)[0])
    hi = np.maximum(fl_node, stellar_flux(grid, 5750.0, 4.0)[0])
    assert np.all(fl4 >= lo * 0.9) and np.all(fl4 <= hi * 1.1)

    # blackbody fallback: Wien check
    wngrid = np.linspace(500.0, 20000.0, 2000)
    bb, _ = blackbody_star(wngrid, 6000.0)
    assert wngrid[np.argmax(bb)] == pytest.approx(1.9611 * 6000.0, rel=0.01)


def test_read_spectrum_roundtrip(tmp_path):
    """read_spectrum parses the bestfit_spectrum.dat format (reference
    readtransit.py:23-64: wavelength um vs value, optional -> cm-1)."""
    from bart_tpu.io.spectrum import read_spectrum

    wn = np.linspace(2000.0, 4000.0, 50)
    val = np.sin(wn / 300.0) + 2.0
    p = tmp_path / "spec.dat"
    with open(p, "w") as f:
        f.write("#wvl [um]    flux\n")
        for w, s in zip(wn[::-1], val[::-1]):   # written descending in wn
            f.write(f"{1e4/w:.9e}  {s:.9e}\n")

    x, v = read_spectrum(str(p), wn=True)
    np.testing.assert_allclose(x, wn, rtol=1e-7)
    np.testing.assert_allclose(v, val, rtol=1e-7)
    xu, vu = read_spectrum(str(p), wn=False)
    np.testing.assert_allclose(xu, np.sort(1e4 / wn), rtol=1e-7)


def test_kurucz_spline_robustness(tmp_path):
    """Zero-flux models must not poison the spline (raw-flux surface,
    clamped at 0) and degenerate grids fall back to bilinear."""
    from bart_tpu.io.kurucz import KuruczGrid, stellar_flux

    nw = 6
    waves = np.linspace(5e-7, 5e-6, nw)
    temps = np.array([3500.0, 3750.0, 4000.0, 4250.0])
    # flux zero at the coolest model (short-wavelength dropout), ~1 elsewhere
    inten = np.ones((8, nw))
    grav = np.tile([4.0, 4.5], 4)
    tcol = np.repeat(temps, 2)
    inten[tcol == 3500.0] = 0.0
    g = KuruczGrid(inten=inten, wave_m=waves, grav=grav, temp=tcol)
    fl, _, _, _ = stellar_flux(g, 3625.0, 4.2, mode="spline")
    assert np.all(fl >= 0)
    fl_hi, _, _, _ = stellar_flux(g, 4000.0, 4.0, mode="nearest")
    assert np.all(fl <= 2.0 * fl_hi)   # no orders-of-magnitude overshoot

    # single-Teff grid: spline must not crash (falls back to bilinear)
    g1 = KuruczGrid(inten=inten[:2], wave_m=waves, grav=grav[:2],
                    temp=tcol[:2])
    fl1, _, _, _ = stellar_flux(g1, 3500.0, 4.2, mode="spline")
    assert fl1.shape == (nw,)


def test_eclipse_single_layer_slab():
    """One-layer atmosphere: I must be B e^{-tau/mu}, not zero."""
    from bart_tpu.rt.eclipse import eclipse_intensity
    from bart_tpu.rt.planck import planck_wn

    wn = jnp.linspace(2000.0, 3000.0, 16)
    T = jnp.asarray([1500.0])
    tau = jnp.full((1, 16), 0.7)
    mu = jnp.asarray([0.5, 1.0])
    I = np.asarray(eclipse_intensity(tau, T, wn, mu))
    B = np.asarray(planck_wn(wn, 1500.0))
    np.testing.assert_allclose(I[1], B * np.exp(-0.7), rtol=1e-10)
    np.testing.assert_allclose(I[0], B * np.exp(-1.4), rtol=1e-10)
