"""End-to-end pipeline/CLI integration tests (small problem sizes)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bart_tpu.driver.config import RetrievalConfig, load_config, load_data_array
from bart_tpu.driver.pipeline import Pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_CFG = os.path.join(REPO, "examples", "demo_eclipse.cfg")


@pytest.fixture(scope="module", autouse=True)
def demo_inputs():
    if not os.path.isfile(
        os.path.join(REPO, "examples", "demo_inputs", "CH4_demo.tli.npz")
    ):
        subprocess.run(
            [sys.executable, os.path.join(REPO, "examples", "make_demo_inputs.py")],
            check=True, cwd=REPO,
        )


def test_config_parses_reference_demo():
    """The reference's own demo config parses (union namespace)."""
    ref_cfg = "/root/reference/examples/demo/BART_eclipse.cfg"
    if not os.path.isfile(ref_cfg):
        pytest.skip("reference not mounted")
    import warnings

    with warnings.catch_warnings(record=True) as wrec:
        warnings.simplefilter("always")
        cfg = load_config(ref_cfg)
    # every reference key is accepted ...
    assert not any("ignored by bart_tpu" in str(w.message) for w in wrec)
    # ... and a config that sets wnosamp is pointed at the live knob
    assert any("rtosamp" in str(w.message) for w in wrec)
    assert cfg.solution == "eclipse"
    assert cfg.molfit == ["CH4"]
    assert cfg.walk == "snooker"
    assert cfg.numit == 50000
    assert cfg.wllow == 2.0 and cfg.wlhigh == 4.0
    np.testing.assert_allclose(
        cfg.params, [-2.0, 0.0, 1.0, 0.0, 0.98, -0.5]
    )
    assert len(load_data_array(cfg.data)) == 10
    assert len(cfg.filters) == 10

    # the transit demo and the WASP-12b regression configs too
    with warnings.catch_warnings(record=True) as wrec:
        warnings.simplefilter("always")
        cfg_t = load_config(
            "/root/reference/examples/demo/BART_transit.cfg")
    assert not any("ignored by bart_tpu" in str(w.message) for w in wrec)
    assert cfg_t.solution == "transit"

    wasp = "/root/reference/examples/WASP-12b/BART.cfg"
    if os.path.isfile(wasp):
        with warnings.catch_warnings(record=True) as wrec:
            warnings.simplefilter("always")
            cfg_w = load_config(wasp)
        assert not any("ignored by bart_tpu" in str(w.message)
                       for w in wrec)
        assert cfg_w.nchains == 10 and cfg_w.numit == 100000
        assert cfg_w.ethresh == 1e-99 and cfg_w.nwidth == 60


def test_config_cli_overrides():
    cfg = load_config(DEMO_CFG, {"numit": "1234", "nchains": "3",
                                 "solution": "transit"})
    assert cfg.numit == 1234 and cfg.nchains == 3
    assert cfg.solution == "transit"


def test_load_data_array(tmp_path):
    assert load_data_array(None) is None
    np.testing.assert_allclose(load_data_array("1.0 2e-3"), [1.0, 2e-3])
    p = tmp_path / "d.npy"
    np.save(p, np.array([3.0, 4.0]))
    np.testing.assert_allclose(load_data_array(str(p)), [3.0, 4.0])
    t = tmp_path / "d.txt"
    t.write_text("5.0\n6.0\n")
    np.testing.assert_allclose(load_data_array(str(t)), [5.0, 6.0])


@pytest.mark.slow
def test_full_pipeline_tiny(tmp_path):
    """Complete pipeline (uniform atm path) at tiny sizes."""
    out = str(tmp_path / "out")
    cfg = load_config(DEMO_CFG, {
        "loc_dir": out, "n_layers": "20", "tempdelt": "650",
        "wndelt": "25", "numit": "2400", "nchains": "4", "burnin": "100",
        "quiet": "True",
    })
    pipe = Pipeline(cfg)
    result = pipe.run()
    assert result is not None
    assert os.path.isfile(os.path.join(out, "output.npy"))
    assert os.path.isfile(os.path.join(out, "MCMC.log"))
    assert os.path.isfile(os.path.join(out, "bestfit_spectrum.dat"))
    assert os.path.isfile(os.path.join(out, "PT_envelope.png"))
    assert os.path.isfile(os.path.join(out, "mcmc_checkpoint.npz"))
    post = np.load(os.path.join(out, "output.npy"))
    assert post.shape[0] == 4 and np.all(np.isfinite(post))

    # --justPlots path reloads from disk:
    pipe2 = Pipeline(cfg, just_plots=True, resume=True)
    pipe2.run()


@pytest.mark.slow
def test_just_opacity_stage(tmp_path):
    out = str(tmp_path / "op")
    cfg = load_config(DEMO_CFG, {
        "loc_dir": out, "n_layers": "12", "tempdelt": "1300",
        "wndelt": "50", "quiet": "True",
    })
    grid = Pipeline(cfg, just_opacity=True).run()
    assert os.path.isfile(os.path.join(out, "opacity_CH4.npz"))
    assert np.asarray(grid.sigma).ndim == 4
    # rerun reuses the file (resume semantics are file-presence based)
    grid2 = Pipeline(cfg, just_opacity=True).run()
    np.testing.assert_allclose(np.asarray(grid2.sigma), np.asarray(grid.sigma))


def test_rtosamp_refines_grid():
    """Plain rtosamp (rtfold=False) runs the whole pipeline at
    wndelt/rtosamp spacing; the default folded mode keeps the output
    grid at wndelt and handles the fine grid in-kernel
    (docs/LINE_SAMPLING.md)."""
    cfg = load_config(DEMO_CFG, {"rtosamp": "4", "rtfold": "False"})
    assert cfg.fold_K == 1
    wn = cfg.wavenumber_grid()
    cfg1 = load_config(DEMO_CFG)
    wn1 = cfg1.wavenumber_grid()
    assert len(wn) == 4 * (len(wn1) - 1) + 1
    np.testing.assert_allclose(wn[::4], wn1, rtol=1e-12)
    # folded (default): output grid unchanged, fold_K carries K
    cfgf = load_config(DEMO_CFG, {"rtosamp": "4"})
    assert cfgf.fold_K == 4
    np.testing.assert_allclose(cfgf.wavenumber_grid(), wn1, rtol=1e-12)


@pytest.mark.slow
def test_pipeline_folded_rtosamp(tmp_path):
    """Full pipeline with folded rtosamp: table built on the fine
    grid, outputs on the wndelt grid, retrieval runs."""
    out = str(tmp_path / "fold")
    cfg = load_config(DEMO_CFG, {
        "loc_dir": out, "n_layers": "16", "tempdelt": "650",
        "wndelt": "25", "rtosamp": "4", "numit": "1600", "nchains": "4",
        "burnin": "100", "quiet": "True", "plots": "False",
    })
    p = Pipeline(cfg)
    result = p.run()
    assert result.posterior.shape[0] == 4
    wn_out = cfg.wavenumber_grid()
    import glob

    grids = glob.glob(os.path.join(out, "*.npz"))
    from bart_tpu.opacity.grid import load_grid

    g = load_grid([g for g in grids if "opacity" in g or "demo" in g][0])
    assert len(g.wn_grid) == 4 * len(wn_out)


def test_justtea_with_builtin_thermo_tables(tmp_path):
    """The equilibrium-chemistry stage with JANAF-grade tabulated
    thermochemistry (thermofile=builtin -> shipped GRI-Mech NASA-7
    data; reference TEA readJANAF capability)."""
    out = str(tmp_path / "tea")
    cfg = load_config(DEMO_CFG, {
        "loc_dir": out, "n_layers": "12", "quiet": "True",
        "uniform": "None", "thermofile": "builtin",
        "out_spec": "H_g He_ref C_g N_g O_g H2_ref CO_g CO2_g CH4_g H2O_g",
    })
    cfg.uniform = None  # force the TEA-equivalent path
    atm = Pipeline(cfg, just_tea=True).run()
    q = atm.abundances
    assert q.shape == (12, 10)
    np.testing.assert_allclose(q.sum(axis=1), 1.0, rtol=1e-8)
    # H2-dominated solar gas
    assert np.all(q[:, 5] > 0.5)


def test_just_spectrum_mode(tmp_path):
    """--justSpectrum computes one spectrum from the atm file's own
    T/q/r columns (the standalone `transit -c cfg` use case,
    SURVEY.md 2.2) and writes the outspec file."""
    from bart_tpu.io.spectrum import read_spectrum

    out = str(tmp_path / "spec")
    cfg = load_config(DEMO_CFG, {
        "loc_dir": out, "n_layers": "16", "tempdelt": "650",
        "wndelt": "25", "quiet": "True",
    })
    wn, spectrum = Pipeline(cfg, just_spectrum=True).run()
    assert np.all(np.isfinite(spectrum)) and spectrum.std() > 0
    path = os.path.join(out, "outspec.dat")
    assert os.path.isfile(path)
    wn_r, spec_r = read_spectrum(path, wn=True)
    np.testing.assert_allclose(np.sort(wn_r), wn, rtol=1e-6)
    np.testing.assert_allclose(np.sort(spec_r)[::-1],
                               np.sort(spectrum)[::-1], rtol=1e-6)

    # consistency: the spectrum from the atm profiles matches the
    # forward model evaluated at the config's own initial parameters
    # (the demo atm was generated from those parameters)
    pipe2 = Pipeline(cfg)
    atm = pipe2.stage_atmosphere(pipe2.stage_pressure(),
                                 pipe2.stage_abundances())
    grid = pipe2.stage_opacity(pipe2.stage_linelist(cfg.wavenumber_grid()),
                               cfg.wavenumber_grid(), atm.pressure)
    fm, like, space = pipe2.stage_forward(atm, cfg.wavenumber_grid(), grid)
    import jax.numpy as jnp
    p = np.array(cfg.params, np.float64)
    p[-1] = 0.0   # atm file carries UNscaled abundances (no molfit factor)
    _, spec_params, valid = fm.jitted()(jnp.asarray(p))
    assert bool(valid)
    np.testing.assert_allclose(spectrum, np.asarray(spec_params),
                               rtol=5e-3)


def test_validate_preflight(tmp_path):
    """--validate: clean demo config passes; injected config faults
    are each caught with a specific issue, nothing is built."""
    from bart_tpu.driver.cli import main as cli_main
    from bart_tpu.driver.validate import validate_config

    # clean
    assert cli_main(["-c", DEMO_CFG, "--validate"]) == 0

    base = load_config(DEMO_CFG)
    cfgdir = os.path.dirname(os.path.abspath(DEMO_CFG))

    def issues_of(**kw):
        cfg = load_config(DEMO_CFG)
        for k, v in kw.items():
            setattr(cfg, k, v)
        return validate_config(cfg, cfgdir)[0]

    # data/filter count mismatch
    iss = issues_of(data=np.ones(7))
    assert any("7 entries" in s for s in iss), iss
    # params outside bounds
    p = np.asarray(base.params).copy()
    p[0] = 99.0
    iss = issues_of(params=p)
    assert any("outside [pmin, pmax]" in s for s in iss), iss
    # wrong parameter count for the layout (parnames too, else the
    # length-consistency check fires first)
    iss = issues_of(params=np.ones(3), pmin=-np.ones(3),
                    pmax=2 * np.ones(3), stepsize=0.1 * np.ones(3),
                    parnames=["a", "b", "c"])
    assert any("expects" in s for s in iss), iss
    # molfit species absent from out_spec
    iss = issues_of(molfit=["XeF6"])
    assert any("XeF6" in s for s in iss), iss
    # missing line data
    iss = issues_of(linedb="/no/such/file.npz", opacityfile=None)
    assert any("linedb" in s for s in iss), iss
    # bad shared-stepsize index
    ss = np.asarray(base.stepsize).copy()
    ss[-1] = -99.0
    iss = issues_of(stepsize=ss)
    assert any("shares parameter" in s for s in iss), iss
    # negative uncertainties
    iss = issues_of(uncert=-np.ones(10))
    assert any("non-positive" in s for s in iss), iss


def test_sampler_knob_keys_parse_and_reach_sampler():
    """Round-5 sampler-tuning keys: snooker_frac/z_thin parse from the
    cfg and reach the EnsembleSampler through run_mcmc."""
    import jax.numpy as jnp

    from bart_tpu.driver.config import load_config
    from bart_tpu.inference.likelihood import Likelihood, ParamSpace
    from bart_tpu.inference import retrieval as rtv

    cfg = load_config(DEMO_CFG, {"snooker_frac": "0.25", "z_thin": "7"})
    assert cfg.snooker_frac == 0.25
    assert cfg.z_thin == 7

    # run_mcmc forwards them to the sampler (captured via the
    # sampler's dataclass fields after construction)
    def forward(p):
        return p, p, jnp.asarray(True)

    space = ParamSpace([0.0], [-5.0], [5.0], [0.1])
    like = Likelihood(forward, space, np.array([0.0]), np.array([1.0]))
    captured = {}
    orig = rtv.EnsembleSampler

    class Spy(orig):
        def __post_init__(self):
            super().__post_init__()
            captured["snooker_frac"] = self.snooker_frac
            captured["z_thin"] = self.z_thin

    rtv.EnsembleSampler, saved = Spy, rtv.EnsembleSampler
    try:
        rtv.run_mcmc(like, space, nchains=4, numit=400, burnin=0,
                     walk="snooker", seed=0, verbose=False, grtest=False,
                     snooker_frac=cfg.snooker_frac, z_thin=cfg.z_thin)
    finally:
        rtv.EnsembleSampler = saved
    assert captured == {"snooker_frac": 0.25, "z_thin": 7}


def test_accuracy_mode_cfg_parses():
    """The committed publication-accuracy cfg (the --fold regression's
    input) keeps its knobs: rtosamp=32 folded, expsum quadrature,
    bf16 tables, numit >= 1e5, and pinned 4-band data."""
    from bart_tpu.driver.config import load_config, load_data_array

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples",
        "wasp12b_eclipse_fold.cfg")
    cfg = load_config(path)
    assert cfg.rtosamp == 32 and cfg.rtfold
    assert cfg.fold_K == 32
    assert cfg.foldtable16 is True
    assert cfg.quadrature == "expsum"
    assert cfg.numit >= 100000
    data = load_data_array(cfg.data)
    uncert = load_data_array(cfg.uncert)
    assert len(data) == 4 and len(uncert) == 4
    np.testing.assert_allclose(uncert, 0.025 * data, rtol=1e-4)


def test_cli_retrieval_imports_no_extra_packages(tmp_path):
    """The retrieval path (cli -> Pipeline.run with plots False) needs
    only JAX (with what JAX's own modules import, e.g. Pallas), numpy
    and scipy — not the plotting extra.  Run in a fresh interpreter,
    tiny sizes."""
    out = str(tmp_path / "out")
    script = f"""
import sys
import jax, jax.numpy, numpy, scipy, scipy.special, scipy.optimize
import jax.experimental.pallas.triton, jax.experimental.custom_partitioning
before = {{m.split('.')[0] for m in sys.modules}}
from bart_tpu.driver.cli import main
rc = main(["-c", {DEMO_CFG!r}, "--loc_dir", {out!r}, "--n_layers", "12",
           "--tempdelt", "650", "--wndelt", "50", "--numit", "400",
           "--nchains", "4", "--burnin", "20", "--plots", "False",
           "--quiet", "True"])
assert rc == 0
new = {{m.split('.')[0] for m in sys.modules}} - before
extra = sorted(m for m in new if m not in sys.stdlib_module_names
               and not m.startswith('_') and m != 'bart_tpu')
print('EXTRA', extra)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("EXTRA")]
    assert line == ["EXTRA []"], (line, res.stdout[-2000:])
    assert os.path.isfile(os.path.join(out, "output.npy"))
