"""HITRAN/HITEMP ``.par`` line-list parser.

Replacement for the reference's pylineread HITRAN driver
(reference: SURVEY.md section 2.2, pylineread dbtype ``hit``; manual
tex:446-503).  Parses the fixed-width 160-character HITRAN 2004+
record format into packed numpy arrays.

Unlike the reference (which converts intensities to gf and stores a
binary TLI), bart_tpu keeps the native HITRAN S(296 K) convention and
scales with partition functions at runtime — fewer conversions, and
direct testability against published HITRAN values.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bart_tpu.linelist.molecules import HITRAN_IDS

__all__ = ["LineList", "read_par", "parse_par_bytes", "ParseReport"]

TREF = 296.0  # HITRAN reference temperature [K]


@dataclasses.dataclass
class ParseReport:
    """Per-file parse diagnostics (the --validate surface).

    Real archive files deviate from the published fixed-width spec in
    known ways — CR/LF endings, Fortran D-exponents, blank fields,
    truncated trailing records (manual tex:446-510 documents the
    formats the reference consumed; this reports exactly what was
    tolerated or dropped instead of failing opaquely)."""

    path: str = ""
    n_lines: int = 0          # physical lines in the file
    n_records: int = 0        # candidate records (>= minimal width)
    n_parsed: int = 0         # records that yielded a line
    n_comment: int = 0        # '#'-prefixed or blank lines
    n_short: int = 0          # lines below the 59-char minimal record
    n_d_exponent: int = 0     # Fortran 'D'/'d' exponents normalized
    n_blank_field: int = 0    # blank numeric fields read as 0
    bad_records: list = dataclasses.field(default_factory=list)
    # (1-based line number, field name, repr snippet) per dropped record

    def summary(self) -> str:
        s = (f"{self.path}: {self.n_parsed}/{self.n_records} records "
             f"parsed ({self.n_comment} comment/blank, "
             f"{self.n_short} short lines)")
        if self.n_d_exponent:
            s += f"; {self.n_d_exponent} D-exponents normalized"
        if self.n_blank_field:
            s += f"; {self.n_blank_field} blank fields -> 0"
        for lineno, fieldname, snip in self.bad_records[:20]:
            s += f"\n  line {lineno}: unparseable {fieldname}: {snip}"
        if len(self.bad_records) > 20:
            s += f"\n  ... {len(self.bad_records) - 20} more"
        return s


@dataclasses.dataclass
class LineList:
    """Packed line data for one species, sorted by line center."""

    species: str
    wn0: np.ndarray        # line centers [cm-1]
    s296: np.ndarray       # intensity at 296K [cm-1/(molec cm-2)]
    elower: np.ndarray     # lower-state energy [cm-1]
    gamma_air: np.ndarray  # air-broadened HWHM at 296K, 1 atm [cm-1/atm]
    gamma_self: np.ndarray # self-broadened HWHM [cm-1/atm]
    n_air: np.ndarray      # T exponent of gamma_air
    iso: np.ndarray        # isotopologue index (int8)

    @property
    def nlines(self) -> int:
        return len(self.wn0)

    def trim(self, wn_min: float, wn_max: float) -> "LineList":
        """Keep lines with centers inside [wn_min, wn_max] (pylineread
        iwav/fwav semantics)."""
        lo, hi = np.searchsorted(self.wn0, [wn_min, wn_max])
        return LineList(
            self.species,
            self.wn0[lo:hi], self.s296[lo:hi], self.elower[lo:hi],
            self.gamma_air[lo:hi], self.gamma_self[lo:hi],
            self.n_air[lo:hi], self.iso[lo:hi],
        )

    def strongest(self, n: int) -> "LineList":
        """Keep the n strongest lines (by S296), re-sorted by wn."""
        if n >= self.nlines:
            return self
        idx = np.sort(np.argpartition(self.s296, -n)[-n:])
        return LineList(
            self.species,
            self.wn0[idx], self.s296[idx], self.elower[idx],
            self.gamma_air[idx], self.gamma_self[idx],
            self.n_air[idx], self.iso[idx],
        )

    def cull(self, ethresh: float) -> "LineList":
        """Drop lines with S296 < ethresh * max(S296) (the reference's
        line-strength cutoff ``ethresh``, demo cfg ethresh 1e-6)."""
        keep = self.s296 >= ethresh * self.s296.max()
        return LineList(
            self.species,
            self.wn0[keep], self.s296[keep], self.elower[keep],
            self.gamma_air[keep], self.gamma_self[keep],
            self.n_air[keep], self.iso[keep],
        )

    @staticmethod
    def concatenate(lists: list["LineList"]) -> "LineList":
        """Merge line lists of the same species, re-sorted by wn
        (pylineread multi-database merge)."""
        sp = lists[0].species
        wn0 = np.concatenate([l.wn0 for l in lists])
        order = np.argsort(wn0, kind="stable")
        cat = lambda f: np.concatenate([getattr(l, f) for l in lists])[order]
        return LineList(
            sp, wn0[order], cat("s296"), cat("elower"),
            cat("gamma_air"), cat("gamma_self"), cat("n_air"), cat("iso"),
        )


_MIN_RECORD = 59  # chars needed for molec..n_air (HITRAN 2004 layout)

_FIELDS = (  # (name, start, end, required)
    ("wn0", 3, 15, True),
    ("s296", 15, 25, True),
    ("gamma_air", 35, 40, False),
    ("gamma_self", 40, 45, False),
    ("elower", 45, 55, True),
    ("n_air", 55, 59, False),
)


def parse_par_bytes(data: bytes, species: str | None = None,
                    on_error: str = "raise",
                    report: ParseReport | None = None
                    ) -> dict[str, LineList]:
    """Parse HITRAN 2004+ fixed-width records from a bytes buffer.

    Returns {species_name: LineList}.  Records of molecules absent from
    the bart_tpu registry are grouped under 'M<id>'.

    Tolerated deviations from the published spec (all common in real
    archive files; counted in ``report`` when given): CR/LF line
    endings, Fortran 'D'/'d' exponents, blank OPTIONAL numeric fields
    (gamma/n_air -> 0), records truncated after column 59 (the
    remaining 160-char fields are unused here).  A record whose
    REQUIRED fields (wn, S296, E") cannot be parsed raises a
    ValueError naming the 1-based line number and field
    (``on_error='raise'``, default) or is dropped and listed in
    ``report.bad_records`` (``on_error='skip'``, the --validate mode).
    """
    rep = report if report is not None else ParseReport()
    lines = data.splitlines()   # handles \n, \r\n, and bare \r
    rep.n_lines = len(lines)
    rows, linenos = [], []
    for i, ln in enumerate(lines):
        if not ln.strip() or ln.startswith(b"#"):
            rep.n_comment += 1
        elif len(ln) < _MIN_RECORD:
            rep.n_short += 1
            if on_error == "raise":
                raise ValueError(
                    f"HITRAN record at line {i + 1} is {len(ln)} chars — "
                    f"shorter than the {_MIN_RECORD}-char minimum "
                    f"(molec..n_air): {ln[:40]!r}")
        else:
            rows.append(ln)
            linenos.append(i + 1)
    rep.n_records = len(rows)
    if not rows:
        raise ValueError("no HITRAN records found")
    linenos = np.asarray(linenos)
    width = max(max(len(r) for r in rows), 60)
    buf = np.zeros((len(rows), width), dtype=np.uint8)
    buf[:] = ord(" ")
    for i, r in enumerate(rows):
        buf[i, : len(r)] = np.frombuffer(r, np.uint8)

    # normalize Fortran D-exponents in the numeric region (cols 3-59)
    for ch, to in ((b"D", b"E"), (b"d", b"e")):
        m = buf[:, 3:_MIN_RECORD] == ch[0]
        if m.any():
            rep.n_d_exponent += int(m.any(axis=1).sum())
            buf[:, 3:_MIN_RECORD][m] = to[0]

    def floats(a, b, name, required):
        w = b - a
        s = buf[:, a:b].tobytes().decode("ascii", "replace")
        arr = np.array([s[i * w:(i + 1) * w] for i in range(len(rows))],
                       dtype="U%d" % w)
        stripped = np.char.strip(arr)
        blank = stripped == ""
        if blank.any():
            if required:
                bad = np.where(blank)[0]
                if on_error == "raise":
                    raise ValueError(
                        f"blank required field {name!r} at line "
                        f"{linenos[bad[0]]}")
            else:
                rep.n_blank_field += int(blank.sum())
            arr = np.where(blank, "0", arr)
        try:
            vals = arr.astype(np.float64)
            ok = ~(blank & required) if required else np.ones(len(rows), bool)
        except ValueError:
            # slow path (dirty file): per-row conversion with precise
            # per-record diagnostics
            vals = np.zeros(len(rows))
            ok = np.ones(len(rows), bool)
            for i, v in enumerate(arr):
                try:
                    vals[i] = float(v)
                except ValueError:
                    ok[i] = False
                    if on_error == "raise":
                        raise ValueError(
                            f"unparseable {name!r} field at line "
                            f"{linenos[i]}: {v!r} "
                            f"(record: {rows[i][:60]!r})") from None
                    rep.bad_records.append(
                        (int(linenos[i]), name, repr(v)))
        if required:
            for i in np.where(blank)[0]:
                ok[i] = False
                rep.bad_records.append(
                    (int(linenos[i]), name, "<blank>"))
        return vals, ok

    valid = np.ones(len(rows), bool)
    vals = {}
    for name, a, b, req in _FIELDS:
        v, ok = floats(a, b, name, req)
        vals[name] = v
        if req:
            valid &= ok

    mol_txt = buf[:, 0:2]
    # first char: digit or (space = single-digit id); second: digit
    mol_ok = np.stack([
        ((mol_txt[:, 0] >= ord("0")) & (mol_txt[:, 0] <= ord("9")))
        | (mol_txt[:, 0] == ord(" ")),
        (mol_txt[:, 1] >= ord("0")) & (mol_txt[:, 1] <= ord("9")),
    ], axis=1)
    mid_bad = ~mol_ok.all(axis=1)
    if mid_bad.any():
        if on_error == "raise":
            i = int(np.where(mid_bad)[0][0])
            raise ValueError(
                f"non-numeric molecule id at line {linenos[i]}: "
                f"{rows[i][:10]!r}")
        for i in np.where(mid_bad)[0]:
            rep.bad_records.append(
                (int(linenos[i]), "molec_id", repr(rows[i][:3])))
        valid &= ~mid_bad
    d10 = np.where(mol_txt[:, 0] == ord(" "), 0, mol_txt[:, 0] - ord("0"))
    mol_id = (10 * d10 + (mol_txt[:, 1] - ord("0"))).astype(np.int32)
    mol_id[mid_bad] = -1
    iso_ch = buf[:, 2]  # single char: '1'-'9','0','A'..
    iso = np.where(
        (iso_ch >= ord("1")) & (iso_ch <= ord("9")), iso_ch - ord("0"),
        np.where(iso_ch == ord("0"), 10,
                 np.where(iso_ch == ord(" "), 1,  # blank isotope -> main
                          iso_ch - ord("A") + 11)),
    ).astype(np.int8)

    rep.n_parsed = int(valid.sum())
    out: dict[str, LineList] = {}
    for mid in np.unique(mol_id[valid]):
        name = HITRAN_IDS.get(int(mid), f"M{int(mid)}")
        if species is not None and name != species:
            continue
        m = valid & (mol_id == mid)
        order = np.argsort(vals["wn0"][m], kind="stable")
        out[name] = LineList(
            name,
            vals["wn0"][m][order], vals["s296"][m][order],
            vals["elower"][m][order],
            vals["gamma_air"][m][order], vals["gamma_self"][m][order],
            vals["n_air"][m][order], iso[m][order],
        )
    return out


def read_par(path: str, species: str | None = None) -> dict[str, LineList]:
    """Read a HITRAN .par file (native C++ fast path when built,
    numpy fallback otherwise)."""
    try:
        from bart_tpu.native import hitran_native

        return hitran_native.read_par(path, species)
    except Exception:
        with open(path, "rb") as f:
            return parse_par_bytes(f.read(), species)
