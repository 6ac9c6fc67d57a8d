#!/usr/bin/env python
"""Generate the self-contained demo inputs.

The reference demo requires downloading HITRAN CH4 data and building a
TLI with pylineread (reference README Quick Example).  Since line data
cannot ship with either repo, this script synthesizes a statistically
CH4-like line list and saves it as a bart_tpu TLI artifact.  It also
writes the demo system, filters and elemental abundances, so the demo
configs and tests read nothing outside the repository.  These inputs
are ASSUMED, not observed:

* ``demo_system.tep``: an HD 209458 b-like system (the synthetic values
  of ``__graft_entry__._build_problem``);
* ``fdemo01.dat`` .. ``fdemo10.dat``: top-hat filters 120 cm-1 wide at
  ten centres from 2600 to 4900 cm-1;
* ``irac1_tophat.dat`` .. ``irac4_tophat.dat``: top-hats at the Spitzer
  IRAC channels' approximate half-power edges (the WASP-12b configs);
* ``abundances_Asplund2009.txt``: the photospheric values of Asplund
  et al. 2009 (ARA&A 47, 481, Table 1) for the elements the demo and
  the chemistry tests use, in the reference's 5-column format.

Usage:  python examples/make_demo_inputs.py [outdir]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


# Demo system (SI): t_star [K], r_star [m], logg_star [cgs], sma [m],
# r_planet [m], m_planet [kg]
DEMO_SYSTEM = (6075.0, 7.97e8, 4.37, 7.05e9, 9.44e7, 1.32e27)
DEMO_FILTER_CENTERS = np.linspace(2600.0, 4900.0, 10)     # [cm-1]
# approximate half-power edges of the Spitzer IRAC channels [um]
IRAC_EDGES = ((3.19, 3.92), (4.02, 5.00), (5.02, 6.40), (6.44, 9.30))

# Asplund et al. 2009, Table 1 photospheric log eps (log eps_H = 12),
# with standard atomic weights [g/mol]
ASPLUND2009 = [
    (1, "H", 12.00, "Hydrogen", 1.008),
    (2, "He", 10.93, "Helium", 4.002602),
    (6, "C", 8.43, "Carbon", 12.011),
    (7, "N", 7.83, "Nitrogen", 14.007),
    (8, "O", 8.69, "Oxygen", 15.999),
    (11, "Na", 6.24, "Sodium", 22.98976928),
    (12, "Mg", 7.60, "Magnesium", 24.305),
    (14, "Si", 7.51, "Silicon", 28.085),
    (15, "P", 5.41, "Phosphorus", 30.973762),
    (16, "S", 7.12, "Sulfur", 32.06),
    (17, "Cl", 5.50, "Chlorine", 35.45),
    (19, "K", 5.03, "Potassium", 39.0983),
    (20, "Ca", 6.34, "Calcium", 40.078),
    (22, "Ti", 4.95, "Titanium", 47.867),
    (23, "V", 3.93, "Vanadium", 50.9415),
    (24, "Cr", 5.64, "Chromium", 51.9961),
    (26, "Fe", 7.50, "Iron", 55.845),
]


def write_system_inputs(outdir):
    """Demo TEP, filters and abundance table (all assumed, see the
    module docstring)."""
    from bart_tpu import constants as const

    t_star, r_star, logg, sma, r_p, m_p = DEMO_SYSTEM
    tep = os.path.join(outdir, "demo_system.tep")
    with open(tep, "w") as f:
        f.write(
            "# Demo system: ASSUMED HD 209458 b-like values, not a\n"
            "# literature fit (written by examples/make_demo_inputs.py).\n"
            "# parameter     value                 uncert  unit   origin\n"
            "planetname      demo-b                -1      -      assumed\n"
            f"Ts              {t_star!r:<21} -1      K      assumed\n"
            f"Rs              {float(r_star / const.RSUN)!r:<21} -1      Rsun   assumed\n"
            f"loggstar        {logg!r:<21} -1      cgs    assumed\n"
            f"a               {sma / const.AU!r:<21} -1      AU     assumed\n"
            f"Rp              {r_p / const.RJUP!r:<21} -1      Rjup   assumed\n"
            f"Mp              {m_p / const.MJUP!r:<21} -1      Mjup   assumed\n"
        )
    print(f"wrote {tep}")

    for i, c in enumerate(DEMO_FILTER_CENTERS, start=1):
        wn = np.linspace(c - 60.0, c + 60.0, 50)
        path = os.path.join(outdir, f"fdemo{i:02d}.dat")
        with open(path, "w") as f:
            f.write(f"# ASSUMED top-hat demo filter centred at {c:.1f} cm-1\n"
                    "# wavelength [um]   transmission\n")
            for w in wn[::-1]:
                f.write(f"{float(1.0 / (w * const.MICRON_TO_CM))!r}  1.0\n")
    print(f"wrote {len(DEMO_FILTER_CENTERS)} filters fdemo01-10.dat")

    for i, (lo, hi) in enumerate(IRAC_EDGES, start=1):
        path = os.path.join(outdir, f"irac{i}_tophat.dat")
        with open(path, "w") as f:
            f.write(f"# ASSUMED top-hat for Spitzer IRAC channel {i}: "
                    f"{lo}-{hi} um\n# wavelength [um]   transmission\n")
            for w in np.linspace(lo, hi, 200):
                f.write(f"{float(w)!r}  1.0\n")
    print(f"wrote {len(IRAC_EDGES)} filters irac1-4_tophat.dat")

    abn = os.path.join(outdir, "abundances_Asplund2009.txt")
    with open(abn, "w") as f:
        f.write("# Elemental abundances: Asplund, Grevesse, Sauval & Scott "
                "2009, ARA&A 47, 481, Table 1 (photosphere).\n"
                "# Subset: the elements the demo and the chemistry tests "
                "use.\n"
                "# Columns: ordinal, symbol, dex abundances, name, "
                "molar mass.\n")
        for idx, sym, dex, name, mass in ASPLUND2009:
            f.write(f"{idx:3d}  {sym:2s}  {dex:5.2f}  {name:10s}  {mass}\n")
    print(f"wrote {abn}")


def main(outdir="examples/demo_inputs"):
    os.makedirs(outdir, exist_ok=True)
    write_system_inputs(outdir)
    from bart_tpu.linelist.tli import TliData, save_tli, synthetic_linelist

    ll = synthetic_linelist(
        "CH4", 2450.0, 5050.0, 30000, seed=20,
        band_centers=(2700.0, 3020.0, 3450.0, 4300.0),
    )
    tli = TliData(["CH4"], {"CH4": ll}, 2450.0, 5050.0)
    tli_path = os.path.join(outdir, "CH4_demo.tli.npz")
    save_tli(tli, tli_path)
    print(f"wrote {tli_path} ({ll.nlines} lines)")

    # synthetic CIA table (H2-H2), smooth in (T, wn):
    from bart_tpu.opacity.cia import CiaTable, write_cia

    temps = np.arange(400.0, 3001.0, 200.0)
    wn = np.linspace(2000.0, 6000.0, 200)
    # Borysow-like magnitude ~1e-7..1e-6 cm-1 amagat-2 with broad bumps
    absorption = (
        1e-7
        * (temps[:, None] / 1000.0) ** 1.5
        * (1.0 + 0.5 * np.exp(-((wn[None, :] - 2400.0) / 500.0) ** 2)
           + 0.3 * np.exp(-((wn[None, :] - 4500.0) / 600.0) ** 2))
    )
    cia_path = os.path.join(outdir, "CIA_H2H2_demo.dat")
    write_cia(CiaTable(("H2", "H2"), temps, wn, absorption), cia_path)
    print(f"wrote {cia_path}")

    # WASP-12b-class 4-molecule line database (910-3400 cm-1, the
    # reference's WASP-12b example range):
    species_bands = {
        "H2O": (1300.0, 1600.0, 1900.0, 3150.0),
        "CO2": (950.0, 1350.0, 2350.0),
        "CO":  (2143.0,),
        "CH4": (1300.0, 3020.0),
    }
    lines = {}
    for k, (name, centers) in enumerate(species_bands.items()):
        lines[name] = synthetic_linelist(
            name, 900.0, 3400.0, 20000, seed=30 + k, band_centers=centers,
        )
    tli4 = TliData(list(lines), lines, 900.0, 3400.0)
    p4 = os.path.join(outdir, "wasp12b_4mol.tli.npz")
    save_tli(tli4, p4)
    print(f"wrote {p4} ({tli4.total_lines()} lines)")


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
