"""Library-API cookbook (reference scripts/quickguide.py equivalent).

A runnable walkthrough of the bart_tpu building blocks: grids, PT
profiles, atmospheres, line lists, opacity, the forward model, and a
small retrieval.  Runs on CPU in under a minute:

  JAX_PLATFORMS=cpu python examples/quickstart.py
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

import jax
import jax.numpy as jnp

# assumed demo inputs (examples/make_demo_inputs.py)
DEMO = os.path.join(REPO, "examples", "demo_inputs")

# --- 1. pressure + wavenumber grids (makeP / makesample equivalents) ---
from bart_tpu.utils.grids import pressure_grid, wavenumber_grid

pressure = pressure_grid(40, 1e-5, 100.0)             # bar, top-first
wn = wavenumber_grid(wllow=2.5, wlhigh=4.0, wndelt=2.0)
print(f"grids: {len(pressure)} layers, {len(wn)} wavenumbers "
      f"[{wn[0]:.0f}, {wn[-1]:.0f}] cm-1")

# --- 2. a temperature profile (PT.py equivalents; 6 models) ---
from bart_tpu.io.tep import PlanetSystem
from bart_tpu.physics.pt import pt_generator

system = PlanetSystem.from_tep(os.path.join(DEMO, "demo_system.tep"))
pt_args = [system.r_star, system.t_star, 100.0, system.sma,
           system.g_planet_cgs, "const"]
T, valid = pt_generator(jnp.asarray(pressure),
                        jnp.asarray([-2.0, 0.0, 1.0, 0.0, 0.98]),
                        "line", pt_args)
print(f"PT 'line' profile: {float(T.min()):.0f}-{float(T.max()):.0f} K "
      f"(valid={bool(valid)})")

# --- 3. equilibrium chemistry (TEA equivalent) ---
from bart_tpu.chem.tea import equilibrium_abundances
from bart_tpu.chem.thermo_tables import builtin_tables
from bart_tpu.io.abundances import read_elements

species = ["H", "He", "C", "O", "H2", "CO", "CO2", "CH4", "H2O"]
elems = read_elements(os.path.join(DEMO, "abundances_Asplund2009.txt"))
tables = builtin_tables(species)          # shipped GRI-Mech NASA-7 data
q_eq = equilibrium_abundances(
    species, ["H", "He", "C", "O"], pressure, np.asarray(T), elems,
    g_tables=tables,
)
print(f"equilibrium: CH4/CO at 1 bar = "
      f"{q_eq[-10, species.index('CH4')]:.2e} / "
      f"{q_eq[-10, species.index('CO')]:.2e}")

# --- 4. a line list + opacity grid (pylineread + --justOpacity) ---
from bart_tpu.linelist.tli import synthetic_linelist
from bart_tpu.opacity.grid import build_opacity_grid

lines = synthetic_linelist("CH4", float(wn[0]), float(wn[-1]), 800, seed=1)
grid = build_opacity_grid({"CH4": lines}, wn,
                          np.arange(400.0, 3001.0, 325.0), pressure)
print(f"opacity grid: sigma{tuple(np.asarray(grid.sigma).shape)}")

# --- 5. the forward model (BARTfunc + transit equivalents) ---
from bart_tpu.io.kurucz import blackbody_star
from bart_tpu.obs.bands import build_band_matrix
from bart_tpu.rt.forward import ForwardConfig, ForwardModel

centers = np.linspace(wn[0] + 60, wn[-1] - 60, 6)
filters = [(np.linspace(c - 50, c + 50, 41), np.ones(41)) for c in centers]
starfl, _ = blackbody_star(wn, system.t_star)
bands = build_band_matrix(wn, filters, star_flux=starfl, rprs=system.rprs)
fm = ForwardModel(
    ForwardConfig(solution="eclipse", pt_type="line", molfit=("CH4",)),
    wn_grid=wn, pressure=pressure, species=["H2", "He", "CH4"],
    base_abundances=np.tile([0.85, 0.149, 1e-3], (len(pressure), 1)),
    opacity=grid, system=system, bands=bands,
)
truth = jnp.asarray([-2.0, 0.0, 1.0, 0.0, 0.98, -0.5], fm.dtype)
bandflux, spectrum, ok = fm.jitted()(truth)
print(f"forward model: {bands.nfilters} band depths, e.g. "
      f"{np.asarray(bandflux)[:3]}")

# --- 6. a tiny retrieval (MC3 equivalent) ---
from bart_tpu.inference.likelihood import Likelihood, ParamSpace
from bart_tpu.inference.retrieval import run_mcmc

data = np.asarray(bandflux)
uncert = 0.03 * data
space = ParamSpace(
    pinit=np.asarray(truth), pmin=[-5, -2, -2, 0, 0.55, -6],
    pmax=[-1, 1, 1, 1, 1.2, 1.5],
    stepsize=[0.1, 0.0, 0.0, 0.0, 0.01, 0.1],   # fit kappa, beta, CH4
)
like = Likelihood(fm, space, data, uncert)
result = run_mcmc(like, space, nchains=8, numit=4000, burnin=100,
                  walk="snooker", seed=1, verbose=False, grtest=False)
print(f"retrieval: best-fit {result.bestp} vs truth "
      f"{np.asarray(truth)[space.ifree]}  (kappa and the CH4 factor are "
      f"degenerate at this S/N — the posterior is wide along that "
      f"direction, as a pairwise plot shows)")
print(f"best loglike {result.best_loglike:.2f}, "
      f"accept rate {result.accept_rate:.2f}")
print("quickstart OK")
