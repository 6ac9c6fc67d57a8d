"""Retrieval configuration: the union [MCMC] namespace.

Reproduces the reference's config system (reference: BART.py:55-289 —
a single INI ``[MCMC]`` section that is the union namespace for
BART+MC3+transit+TEA arguments, with a two-pass parser: ``-c`` file
first, then CLI overrides).  bart_tpu reads the same INI files the
reference ships (examples/demo/BART_eclipse.cfg parses unchanged) and
projects the namespace into its own stages — no makecfg fan-out files
needed (SURVEY.md section 5, Config/flag system).
"""

from __future__ import annotations

import configparser
import dataclasses
import os
import shlex
from typing import Any

import numpy as np

__all__ = ["RetrievalConfig", "load_config", "parse_array"]


def parse_array(val) -> np.ndarray | None:
    """MC3's mu.parray semantics: whitespace-separated floats (or file
    path / None)."""
    if val is None or val == "None":
        return None
    if isinstance(val, np.ndarray):
        return val
    if isinstance(val, (list, tuple)):
        return np.asarray(val, np.float64)
    return np.asarray([float(x) for x in str(val).split()], np.float64)


def parse_strlist(val) -> list[str] | None:
    if val is None or val == "None":
        return None
    if isinstance(val, (list, tuple)):
        return list(val)
    return str(val).split()


def parse_bool(val) -> bool:
    if isinstance(val, bool):
        return val
    return str(val).strip().lower() in ("true", "1", "yes", "on")


@dataclasses.dataclass
class RetrievalConfig:
    """Union of the reference's BART/MC3/transit/TEA argument surface
    (reference: BART.py:55-264 argparse; makecfg.py:36-52 transit
    known_args; makecfg.py:111-201 MCMC keys; makecfg.py:204-255 TEA)."""

    # --- directories / files (BART.py:72-86) ---
    loc_dir: str = "outdir"
    tep_name: str | None = None
    logfile: str = "MCMC.log"
    fext: str = ".png"

    # --- pressure grid (BART.py:87-105) ---
    n_layers: int = 100
    p_top: float = 1.0e-5
    p_bottom: float = 100.0
    log: bool = True
    press_file: str | None = None

    # --- elemental abundances (BART.py:108-121) ---
    # default: the in-repo Asplund et al. 2009 subset written by
    # examples/make_demo_inputs.py (the elements the demo uses)
    abun_basic: str = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "examples", "demo_inputs", "abundances_Asplund2009.txt")
    abun_file: str | None = None
    solar_times: float = 1.0
    COswap: bool = False

    # --- temperature profile (BART.py:124-131) ---
    PTtype: str = "line"
    PTinit: np.ndarray | None = None
    tint: float = 100.0
    tint_type: str = "const"

    # --- atmosphere (BART.py:134-165) ---
    in_elem: str = "H He C N O"
    # tabulated thermochemistry for the equilibrium stage: a NASA-7
    # (CHEMKIN) file path, or 'builtin' for the shipped GRI-Mech data
    # (the reference TEA's JANAF-table capability, SURVEY.md 2.4);
    # empty -> analytic free-atom thermochemistry (chem/thermo.py)
    thermofile: str | None = None
    out_spec: str = "H_g He_ref C_g N_g O_g H2_ref CO_g CO2_g CH4_g H2O_g"
    preatm_file: str = "elem.atm"
    atmfile: str = ""
    uniform: np.ndarray | None = None
    refpress: float = 0.1
    cloudtop: float | None = None
    cloudrad: np.ndarray | None = None   # (r_top, r_bot) in cloudfct units
    cloudfct: float = 1e5                # cm per cloudrad unit (km default)
    cloudext: float = 0.0                # extended-cloud extinction [cm-1]
    scattering: str | None = None

    # --- MCMC (BART.py:167-227; MC3 cfg keys) ---
    params: np.ndarray | None = None
    pmin: np.ndarray | None = None
    pmax: np.ndarray | None = None
    stepsize: np.ndarray | None = None
    parnames: list[str] | None = None
    molfit: list[str] | None = None
    Tmin: float = 400.0
    Tmax: float = 3000.0
    numit: int = 50000
    nchains: int = 10
    burnin: int = 500
    walk: str = "snooker"
    thinning: int = 1
    leastsq: bool = False
    chisqscale: bool = False
    wlike: bool = False   # Carter & Winn 2009 wavelet likelihood (MC3 dwt.c);
                          # appends (gamma, sigma_r, sigma_w) to params
    grtest: bool = True
    grexit: bool = False
    grbreak: float = 1.01        # split-R-hat threshold for grexit
    seed: int = 0
    # snooker-walk tuning (bart_tpu extensions; defaults = the
    # round-5 WASP-12b ESS/s sweep optimum, examples/sampler_sweep.py)
    snooker_frac: float = 0.1    # fraction of snooker (vs parallel) moves
    z_thin: int = 30             # snooker archive append period [iters]
    data: Any = None
    uncert: Any = None
    savemodel: str | None = None
    modelper: int = 0
    plots: bool = True
    quiet: bool = False

    # --- output converter (BART.py:230-247) ---
    filters: list[str] | None = None
    kurucz: str | None = None
    solution: str = "eclipse"
    ebalance: bool = False

    # --- transit / spectrum (makecfg.py:36-52 known_args) ---
    linedb: str | None = None
    csfile: list[str] | None = None
    molfile: str | None = None
    wllow: float | None = None
    wlhigh: float | None = None
    wlfct: float = 1e-4
    wnlow: float | None = None
    wnhigh: float | None = None
    wndelt: float = 1.0
    wnosamp: float = 2160.0      # accepted, unused (see rtosamp)
    # RT-grid oversampling: the whole pipeline (opacity, tau, flux,
    # band integration) runs at wndelt/rtosamp spacing.  Replaces the
    # reference's wnosamp with spectrum-level resolution — the only
    # unbiased route to band-flux accuracy (docs/LINE_SAMPLING.md);
    # the reference tabulates Voigt profiles on its wnosamp-fine grid
    # but still point-samples tau/flux at the output spacing.
    rtosamp: int = 1
    # Fold the rtosamp fine grid into a sub-sample axis of the table
    # (rt.fused: outputs, band matrix, and Planck run
    # at the wndelt bins — same unbiased average-after-exp result,
    # K-times smaller tables of the plain mode avoided): default on.
    # rtfold=False recovers the plain everything-on-the-fine-grid mode.
    rtfold: bool = True
    # Static adaptive in-bin resolution for folded rtosamp: only bins
    # with in-bin line structure (opacity.grid.fine_bin_mask) pay the
    # K-sub-sample cost; smooth bins run at K=1 on bin-mean tables
    # (error bound 0.27 delta^2 ~ 1e-4).  Turn off for wn-sharded
    # multi-chip runs (the split permutes the wn axis).
    rtadapt: bool = True
    # Store the K-times-fine folded tables in bfloat16: HALVES the fine
    # table's device residency and host->device upload (a 4-molecule
    # WASP K=32 table is 3.6 GB in f32); each sub-sample slice is
    # widened to f32 before its HIGHEST-precision contraction, so the
    # only error is the bf16 rounding of the table (band fluxes within
    # 2e-3, tests/test_fused.py).  Off by default: the reference-parity
    # and CPU test paths keep full-f32 tables.
    foldtable16: bool = False
    # sigma-bin-averaged cross-sections (arctan-quadrature points per
    # bin); biased for saturated lines — see docs/LINE_SAMPLING.md
    osamp: int = 1
    wnfct: float = 1.0
    toomuch: float = 10.0
    ethresh: float = 1e-6
    nwidth: float = 20.0
    raygrid: np.ndarray | None = None
    # eclipse angular quadrature: 'raygrid' (reference parity) or
    # 'expsum' (exact-E3 exponential-sum fit: ~65x more accurate than
    # the 5-angle raygrid AND single-exponential in the fused kernels)
    quadrature: str = "raygrid"
    nquad: int = 8
    tlow: float = 400.0
    thigh: float = 3000.0
    tempdelt: float = 100.0
    opacityfile: str | None = None
    outspec: str = "outspec.dat"
    outintens: str | None = None   # per-angle intensity dump (eclipse)
    outtoomuch: str | None = None  # radius where tau hits `toomuch`
    outsample: str | None = None   # sampling-grid dump
    savefiles: bool = False        # dump tau.dat etc. (transit savefiles)
    shareOpacity: bool = True    # accepted, unused (tables are device arrays)
    tconfig: str = "transit.cfg" # accepted, unused (no subprocess fan-out)
    mpi: bool = True             # accepted, unused (no MPI: single program)
    func: str | None = None      # accepted, unused (likelihood is in-process)
    # -- accepted-for-compatibility transit flags (makecfg.py:36-52).
    # Radius sampling is derived from the pressure grid (hydrostatic,
    # physics/hydro.py) so radlow/radhigh/raddelt only clip/inform; the
    # geometry stubs (starrad/transparent) match the reference's stubs.
    radlow: float | None = None
    radhigh: float | None = None
    raddelt: float | None = None
    radfct: float = 1e5
    allowq: float | None = None
    tauiso: int = 0
    outtau: str | None = None
    taulevel: int | None = None
    modlevel: int | None = None
    starrad: float | None = None
    transparent: bool = False
    verb: int = 0
    gsurf: float | None = None      # computed from TEP when absent
    refradius: float | None = None  # computed from TEP when absent
    orbpars: np.ndarray | None = None
    orbparsfct: np.ndarray | None = None

    # --- TEA (makecfg.py:204-255) ---
    maxiter: int = 100

    @property
    def fold_K(self) -> int:
        """Sub-samples per output bin handled IN-KERNEL (rtfold mode);
        1 when rtosamp is off or the plain fine-grid mode is forced."""
        K = max(int(self.rtosamp), 1)
        return K if (self.rtfold and K > 1) else 1

    def wavenumber_grid(self) -> np.ndarray:
        """The pipeline's OUTPUT wavenumber grid.  In plain-rtosamp
        mode (rtfold=False) this is the K-times-refined RT grid; in
        folded mode the output stays at wndelt spacing and the fine
        grid (utils.grids.folded_fine_grid) exists only inside the
        opacity table and the fused kernels."""
        from bart_tpu.utils.grids import wavenumber_grid

        K = max(int(self.rtosamp), 1)
        return wavenumber_grid(
            wnlow=self.wnlow, wnhigh=self.wnhigh,
            wndelt=self.wndelt if self.fold_K > 1 else self.wndelt / K,
            wllow=self.wllow, wlhigh=self.wlhigh, wlfct=self.wlfct,
            wnfct=self.wnfct,
        )


_ARRAY_KEYS = {"params", "pmin", "pmax", "stepsize", "PTinit", "uniform",
               "raygrid", "cloudrad", "orbpars", "orbparsfct"}
_STRLIST_KEYS = {"parnames", "molfit", "filters", "csfile"}
_BOOL_KEYS = {"log", "COswap", "leastsq", "chisqscale", "grtest", "grexit",
              "plots", "quiet", "ebalance", "shareOpacity", "savefiles",
              "transparent", "wlike", "mpi", "rtfold", "rtadapt",
              "foldtable16"}
_INT_KEYS = {"n_layers", "numit", "nchains", "burnin", "thinning",
             "modelper", "maxiter", "seed", "tauiso", "taulevel",
             "modlevel", "verb", "rtosamp", "osamp", "nquad", "z_thin"}
_FLOAT_KEYS = {"p_top", "p_bottom", "solar_times", "refpress", "cloudtop",
               "Tmin", "Tmax", "tint", "wllow", "wlhigh", "wlfct", "wnlow",
               "wnhigh", "wndelt", "wnosamp", "wnfct", "toomuch", "ethresh",
               "nwidth", "tlow", "thigh", "tempdelt", "cloudfct", "cloudext",
               "radlow", "radhigh", "raddelt", "radfct", "allowq", "starrad",
               "gsurf", "refradius", "snooker_frac", "grbreak"}


def load_config(path: str | None = None, overrides: dict | None = None
                ) -> RetrievalConfig:
    """Parse an INI [MCMC] config (reference format) + overrides.

    Unknown keys are collected and warned about rather than fatal
    (the reference forwards its whole namespace to every tool).
    """
    raw: dict[str, str] = {}
    if path:
        cp = configparser.ConfigParser()
        cp.optionxform = str  # preserve case (reference BART.py:52)
        read = cp.read([path])
        if not read:
            raise FileNotFoundError(path)
        raw.update(dict(cp.items("MCMC")))
    if overrides:
        raw.update({k: v for k, v in overrides.items() if v is not None})

    cfg = RetrievalConfig()
    known = {f.name for f in dataclasses.fields(RetrievalConfig)}
    unknown = []
    cfgdir = os.path.dirname(os.path.abspath(path)) if path else os.getcwd()

    def absolutize(v: str) -> str:
        if isinstance(v, str) and ("/" in v or v.startswith(".")) and not os.path.isabs(v):
            return os.path.normpath(os.path.join(cfgdir, v))
        return v

    for key, val in raw.items():
        if key not in known:
            unknown.append(key)
            continue
        if key in _ARRAY_KEYS:
            val = parse_array(val)
        elif key in _STRLIST_KEYS:
            val = parse_strlist(val)
            if val is not None and key in ("filters", "csfile"):
                val = [absolutize(v) for v in val]
        elif key in _BOOL_KEYS:
            val = parse_bool(val)
        elif key in _INT_KEYS:
            val = int(float(val)) if val not in (None, "None") else None
        elif key in _FLOAT_KEYS:
            val = float(val) if val not in (None, "None") else None
        elif key in ("data", "uncert"):
            pass  # resolved later (array literal or file path)
        elif isinstance(val, str):
            val = absolutize(val) if key in (
                "tep_name", "press_file", "abun_basic", "abun_file",
                "atmfile", "preatm_file", "linedb", "molfile", "kurucz",
                "opacityfile", "loc_dir", "thermofile",
            ) else val
            if val == "None":
                val = None
        setattr(cfg, key, val)

    if unknown:
        import warnings

        warnings.warn(f"config keys ignored by bart_tpu: {sorted(unknown)}")
    if "wnosamp" in raw and "rtosamp" not in raw:
        import warnings

        warnings.warn(
            "config sets `wnosamp` (the reference's Voigt-tabulation "
            "oversampling) — bart_tpu evaluates Voigt profiles at exact "
            "line centers, so wnosamp is a no-op here.  Spectrum-level "
            "resolution is controlled by `rtosamp` (default 1 = "
            "reference-parity point sampling; 32 = <1e-4 band-flux "
            "accuracy).  See docs/LINE_SAMPLING.md."
        )
    return cfg


def load_data_array(val, cfgdir: str = ".") -> np.ndarray | None:
    """Resolve data/uncert: inline numbers, .npy, .npz, or text file
    (reference BART.py:385-436)."""
    if isinstance(val, np.ndarray):
        return val
    if val is None or val == "None":
        return None
    s = str(val).strip()
    tokens = s.split()
    try:
        return np.asarray([float(t) for t in tokens], np.float64)
    except ValueError:
        pass
    path = tokens[0]
    if not os.path.isabs(path):
        path = os.path.join(cfgdir, path)
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        z = np.load(path)
        return z[list(z.keys())[0]]
    return np.loadtxt(path).ravel()
