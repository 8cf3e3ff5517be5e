"""MPS file parser (fixed and free format).

Counterpart of cuopt_tpu/io/mps_parser.py. Behavioral parity with the
reference parser (cpp/libmps_parser/src/mps_parser.cpp, parse_mps() at
include/mps_parser/parser.hpp:35), including:

  - sections NAME / OBJSENSE / OBJNAME / ROWS / COLUMNS (with integer
    MARKERs) / RHS / RANGES / BOUNDS / ENDATA;
  - an RHS entry on the objective row sets objective_offset = -value
    (mps_parser.cpp:795);
  - RANGES semantics (mps_parser.cpp:174-240): E row, range v>=0 ->
    [rhs, rhs+v], v<0 -> [rhs+v, rhs]; G row -> [rhs, rhs+|v|];
    L row -> [rhs-|v|, rhs];
  - BOUNDS semantics (mps_parser.cpp:1020+): UP < 0 with no prior bound
    sets lower to -inf (CPLEX convention); BV -> integer in [0,1]; LI with
    no prior bound raises upper to +inf; SC (semi-continuous) rejected;
  - errors on: duplicate rows, unknown rows/columns, non-contiguous
    COLUMNS entries, missing objective row, bad numeric values, unknown
    sections, data before the first section, truncated entry pairs.

Free rows (N rows beyond the objective) are tracked and their
coefficients dropped, as in the reference.
"""

from __future__ import annotations

import math
import re

import numpy as np

from cuopt_torch.constants import CUOPT_CONTINUOUS, CUOPT_INTEGER
from cuopt_torch.problem.data_model import OptimizationProblem
from cuopt_torch.utils.errors import MpsParseError

INF = math.inf

_SECTIONS = {
    "NAME", "OBJSENSE", "OBJSENS", "OBJNAME", "ROWS", "COLUMNS", "RHS",
    "RANGES", "BOUNDS", "ENDATA",
}

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?$")


def _to_float(tok: str, line: str) -> float:
    t = tok.strip()
    low = t.lower()
    if low in ("inf", "+inf", "infinity", "+infinity", "1e30", "1e+30"):
        return INF
    if low in ("-inf", "-infinity", "-1e30", "-1e+30"):
        return -INF
    if not _NUM_RE.match(t):
        raise MpsParseError(f"Bad numeric value {tok!r} in line: {line!r}")
    return float(t.replace("d", "e").replace("D", "E"))


def _is_number(tok: str) -> bool:
    return bool(_NUM_RE.match(tok.strip())) or tok.strip().lower() in (
        "inf", "-inf", "+inf", "infinity", "-infinity", "+infinity",
    )


class _MpsParser:
    def __init__(self, fixed_format: bool):
        self.fixed = fixed_format
        self.problem_name = ""
        self.objective_name: str | None = None
        self.objname_directive: str | None = None
        self.maximize = False
        self.row_types: list[str] = []
        self.row_names: list[str] = []
        self.row_map: dict[str, int] = {}
        self.free_rows: set[str] = set()
        self.var_names: list[str] = []
        self.var_map: dict[str, int] = {}
        self.var_types: list[str] = []
        # per-variable coefficient lists (CSC-ish during parse)
        self.col_rows: list[list[int]] = []
        self.col_vals: list[list[float]] = []
        self.obj_coeffs: dict[int, float] = {}
        self.rhs_values: dict[int, float] = {}
        self.range_values: dict[int, float] = {}
        self.objective_offset = 0.0
        self.lb: dict[int, float] = {}
        self.ub: dict[int, float] = {}
        self.bounds_defined: set[int] = set()
        self.saw_columns = False
        self.saw_rows = False
        self.in_integer_block = False
        self.closed_vars: set[str] = set()
        self.current_var: str | None = None

    # ---------------------------------------------------------------- parse
    def _data_tokens(self, raw: str, section: str) -> list[str] | None:
        """Tokenize a data line. Free format: whitespace split. Fixed format:
        extract the standard MPS field columns (so names may contain spaces).
        A `$` starting a field comments out the rest of the line. Returns
        None when the line becomes empty/noop after comment stripping."""
        if self.fixed:
            # 0-indexed standard MPS field column ranges
            f = [
                raw[1:3].strip(), raw[4:12].strip(), raw[14:22].strip(),
                raw[24:36].strip(), raw[39:47].strip(), raw[49:61].strip(),
            ]
            # $ comment: truncate at the field that starts with $
            for k in range(6):
                if f[k].startswith("$"):
                    f = f[:k] + [""] * (6 - k)
                    break
            if section == "ROWS":
                toks = [f[0], f[1]]
            elif section == "BOUNDS":
                toks = [f[0], f[1], f[2]] + ([f[3]] if f[3] else [])
            elif section in ("COLUMNS", "RHS", "RANGES"):
                toks = [f[1], f[2]] + ([f[3]] if f[3] else [])
                if f[4]:
                    toks += [f[4]] + ([f[5]] if f[5] else [])
                if len(toks) == 1:
                    return None  # only a name left after comment stripping
            else:
                toks = [t for t in f if t]
            return [t for t in toks if t != ""] or None
        toks = raw.split()
        truncated = False
        for k, t in enumerate(toks):
            if t.startswith("$"):
                toks = toks[:k]
                truncated = True
                break
        if not toks:
            return None
        if truncated and section in ("COLUMNS", "RHS", "RANGES") and (
            len(toks) == 1
        ):
            return None
        return toks

    def parse(self, text: str) -> OptimizationProblem:
        section = None
        for raw in text.splitlines():
            if not raw.strip():
                continue
            if raw[0] in "*$":
                continue
            if raw[0] not in " \t":
                # section header line
                toks = raw.split()
                sec = toks[0].upper()
                if sec not in _SECTIONS:
                    raise MpsParseError(f"Unknown section {toks[0]!r}")
                section = sec
                if sec == "NAME":
                    self.problem_name = toks[1] if len(toks) > 1 else ""
                elif sec in ("OBJSENSE", "OBJSENS") and len(toks) > 1:
                    self._set_objsense(toks[1])
                    section = "_DONE"
                elif sec == "OBJNAME" and len(toks) > 1:
                    self.objname_directive = toks[1]
                    section = "_DONE"
                elif sec == "COLUMNS":
                    self.saw_columns = True
                elif sec == "ENDATA":
                    break
                continue
            # data line
            if section is None:
                raise MpsParseError(
                    f"Data line before any section: {raw!r}"
                )
            if section == "COLUMNS" and "MARKER" in raw.upper():
                if "INTORG" in raw.upper():
                    self.in_integer_block = True
                    self.saw_columns = True
                    continue
                if "INTEND" in raw.upper():
                    self.in_integer_block = False
                    continue
            toks = self._data_tokens(raw, section or "")
            if toks is None:
                continue
            if section in ("NAME", "_DONE"):
                raise MpsParseError(f"Unexpected data line: {raw!r}")
            elif section in ("OBJSENSE", "OBJSENS"):
                self._set_objsense(toks[0])
                section = "_DONE"
            elif section == "OBJNAME":
                self.objname_directive = toks[0]
                section = "_DONE"
            elif section == "ROWS":
                self._parse_row(toks, raw)
            elif section == "COLUMNS":
                self.saw_columns = True
                self._parse_column(toks, raw)
            elif section == "RHS":
                self._parse_rhs(toks, raw)
            elif section == "RANGES":
                self._parse_range(toks, raw)
            elif section == "BOUNDS":
                self._parse_bound(toks, raw)
        return self._finalize()

    def _set_objsense(self, tok: str):
        t = tok.upper()
        if t in ("MAX", "MAXIMIZE"):
            self.maximize = True
        elif t in ("MIN", "MINIMIZE"):
            self.maximize = False
        else:
            raise MpsParseError(f"Bad OBJSENSE value {tok!r}")

    # ----------------------------------------------------------------- rows
    def _parse_row(self, toks: list[str], raw: str):
        self.saw_rows = True
        if len(toks) < 2:
            raise MpsParseError(f"ROWS entry needs type and name: {raw!r}")
        rtype = toks[0].upper()
        name = toks[1]
        if rtype == "N":
            if self.objective_name is None:
                self.objective_name = name
                self.free_rows.add(name)  # resolved in _finalize
            else:
                self.free_rows.add(name)
            return
        if rtype not in ("L", "G", "E"):
            raise MpsParseError(f"Bad row type {rtype!r} in line {raw!r}")
        if name in self.row_map or name in self.free_rows:
            raise MpsParseError(f"Duplicate row {name!r}")
        self.row_map[name] = len(self.row_names)
        self.row_names.append(name)
        self.row_types.append(rtype)

    # -------------------------------------------------------------- columns
    def _parse_column(self, toks: list[str], raw: str):
        if len(toks) >= 3 and toks[1].upper() == "'MARKER'":
            marker = toks[2].strip("'").upper()
            if marker == "INTORG":
                self.in_integer_block = True
            elif marker == "INTEND":
                self.in_integer_block = False
            return
        if "'MARKER'" in (t.upper() for t in toks):
            # marker fields can be in other positions in fixed format
            joined = " ".join(toks).upper()
            if "INTORG" in joined:
                self.in_integer_block = True
                return
            if "INTEND" in joined:
                self.in_integer_block = False
                return
        if len(toks) < 3 or len(toks) % 2 == 0:
            raise MpsParseError(f"Bad COLUMNS entry: {raw!r}")
        var = toks[0]
        if var != self.current_var:
            if var in self.closed_vars:
                raise MpsParseError(
                    f"COLUMNS entries for {var!r} are not contiguous"
                )
            if self.current_var is not None:
                self.closed_vars.add(self.current_var)
            self.current_var = var
            self.var_map[var] = len(self.var_names)
            self.var_names.append(var)
            self.var_types.append(
                CUOPT_INTEGER if self.in_integer_block else CUOPT_CONTINUOUS
            )
            self.col_rows.append([])
            self.col_vals.append([])
        j = self.var_map[var]
        for k in range(1, len(toks), 2):
            rname, vtok = toks[k], toks[k + 1]
            val = _to_float(vtok, raw)
            if rname == self.objective_name:
                self.obj_coeffs[j] = self.obj_coeffs.get(j, 0.0) + val
            elif rname in self.row_map:
                self.col_rows[j].append(self.row_map[rname])
                self.col_vals[j].append(val)
            elif rname in self.free_rows:
                continue  # non-objective free row: coefficient dropped
            else:
                raise MpsParseError(
                    f"Unknown row {rname!r} in COLUMNS line {raw!r}"
                )

    # ------------------------------------------------------------------ rhs
    def _iter_pairs(self, toks: list[str], raw: str, known):
        """Yield (row_or_var_name, value_token) pairs, handling the optional
        leading set name (RHS/RANGES set names are ignored,
        mps_parser.cpp:881)."""
        start = 1
        if (
            toks[0] in known
            and len(toks) >= 2
            and _is_number(toks[1])
            and len(toks) % 2 == 0
        ):
            start = 0
        rest = toks[start:]
        if not rest or len(rest) % 2 != 0:
            raise MpsParseError(f"Bad entry pairs in line: {raw!r}")
        for k in range(0, len(rest), 2):
            yield rest[k], rest[k + 1]

    def _parse_rhs(self, toks: list[str], raw: str):
        known = dict(self.row_map)
        if self.objective_name is not None:
            known[self.objective_name] = -1
        for rname, vtok in self._iter_pairs(toks, raw, known):
            val = _to_float(vtok, raw)
            if rname == self.objective_name:
                # RHS on the objective row: offset = -value
                self.objective_offset = -val
            elif rname in self.row_map:
                self.rhs_values[self.row_map[rname]] = val
            elif rname in self.free_rows:
                continue
            else:
                raise MpsParseError(f"Unknown row {rname!r} in RHS: {raw!r}")

    def _parse_range(self, toks: list[str], raw: str):
        for rname, vtok in self._iter_pairs(toks, raw, self.row_map):
            val = _to_float(vtok, raw)
            if rname not in self.row_map:
                raise MpsParseError(
                    f"Unknown row {rname!r} in RANGES: {raw!r}"
                )
            self.range_values[self.row_map[rname]] = val

    # --------------------------------------------------------------- bounds
    _BOUND_NO_VALUE = {"FR", "MI", "PL", "BV"}
    _BOUND_VALUE = {"LO", "UP", "FX", "LI", "UI"}

    def _parse_bound(self, toks: list[str], raw: str):
        btype = toks[0].upper()
        if btype == "SC":
            raise MpsParseError(
                f"Unsupported semi-continuous bound type: {raw!r}"
            )
        if btype not in self._BOUND_NO_VALUE | self._BOUND_VALUE:
            raise MpsParseError(f"Invalid bound type {btype!r}: {raw!r}")
        rest = toks[1:]
        if not rest:
            raise MpsParseError(f"BOUNDS entry missing variable: {raw!r}")
        # optional bound-set name before the variable name
        if rest[0] not in self.var_map and len(rest) >= 2 and (
            rest[1] in self.var_map
            or (not _is_number(rest[1]) and len(rest) >= 2)
        ):
            rest = rest[1:]
        var = rest[0]
        if var not in self.var_map:
            # Variables may first appear in BOUNDS (zero objective, no
            # matrix entries) — the reference accepts this
            # (datasets/mip/trivial-presolve-no-obj-vars.mps).
            self.var_map[var] = len(self.var_names)
            self.var_names.append(var)
            self.var_types.append(
                CUOPT_INTEGER if self.in_integer_block else CUOPT_CONTINUOUS
            )
            self.col_rows.append([])
            self.col_vals.append([])
        j = self.var_map[var]
        val = None
        if btype in self._BOUND_VALUE:
            if len(rest) < 2:
                raise MpsParseError(f"BOUNDS entry missing value: {raw!r}")
            val = _to_float(rest[1], raw)
        had_prior = j in self.bounds_defined
        if btype == "LO":
            self.lb[j] = val
        elif btype == "UP":
            self.ub[j] = val
            if not had_prior and val < 0:
                self.lb[j] = -INF
        elif btype == "FX":
            self.lb[j] = val
            self.ub[j] = val
        elif btype == "FR":
            self.lb[j] = -INF
            self.ub[j] = INF
        elif btype == "MI":
            self.lb[j] = -INF
        elif btype == "PL":
            self.ub[j] = INF
        elif btype == "BV":
            self.lb[j] = 0.0
            self.ub[j] = 1.0
            self.var_types[j] = CUOPT_INTEGER
        elif btype == "LI":
            if not had_prior:
                self.ub[j] = INF
            self.lb[j] = val
            self.var_types[j] = CUOPT_INTEGER
        elif btype == "UI":
            self.ub[j] = val
            if not had_prior and val < 0:
                self.lb[j] = -INF
            self.var_types[j] = CUOPT_INTEGER
        self.bounds_defined.add(j)

    # ------------------------------------------------------------- finalize
    def _finalize(self) -> OptimizationProblem:
        if self.objective_name is None:
            raise MpsParseError("No objective (N) row found")
        if not self.saw_rows:
            raise MpsParseError("Missing ROWS section")
        if not self.saw_columns:
            raise MpsParseError("Missing COLUMNS section")
        if self.objname_directive is not None:
            # OBJNAME selects which N row is the objective. Entries already
            # attributed assuming first-N-row; re-attribution is only needed
            # when the directive names a different row.
            if self.objname_directive not in self.free_rows:
                raise MpsParseError(
                    f"OBJNAME row {self.objname_directive!r} not found"
                )
            self.objective_name = self.objname_directive
            # Re-parse attribution is handled by parse_mps() (second pass).
        n = len(self.row_names)
        m = len(self.var_names)

        # constraint bounds from row types + rhs + ranges
        lc = np.empty(n, np.float64)
        uc = np.empty(n, np.float64)
        rhs = np.zeros(n, np.float64)
        for i, t in enumerate(self.row_types):
            b = self.rhs_values.get(i, 0.0)
            rhs[i] = b
            if t == "E":
                lc[i] = uc[i] = b
            elif t == "G":
                lc[i], uc[i] = b, INF
            else:  # L
                lc[i], uc[i] = -INF, b
        for i, v in self.range_values.items():
            t = self.row_types[i]
            b = rhs[i]
            if t == "E":
                if v >= 0:
                    uc[i] = b + v
                else:
                    lc[i] = b + v
            elif t == "G":
                uc[i] = lc[i] + abs(v)
            else:  # L
                lc[i] = uc[i] - abs(v)

        # CSC -> CSR
        col_counts = np.array([len(r) for r in self.col_rows], np.int64)
        nnz = int(col_counts.sum())
        rows_flat = np.empty(nnz, np.int64)
        cols_flat = np.empty(nnz, np.int64)
        vals_flat = np.empty(nnz, np.float64)
        pos = 0
        for j in range(m):
            k = len(self.col_rows[j])
            rows_flat[pos:pos + k] = self.col_rows[j]
            cols_flat[pos:pos + k] = j
            vals_flat[pos:pos + k] = self.col_vals[j]
            pos += k
        order = np.argsort(rows_flat, kind="stable")
        rows_s = rows_flat[order]
        offsets = np.zeros(n + 1, np.int64)
        np.add.at(offsets, rows_s + 1, 1)
        np.cumsum(offsets, out=offsets)

        c = np.zeros(m, np.float64)
        for j, v in self.obj_coeffs.items():
            c[j] = v
        lb = np.zeros(m, np.float64)
        ub = np.full(m, INF, np.float64)
        for j, v in self.lb.items():
            lb[j] = v
        for j, v in self.ub.items():
            ub[j] = v
        # Integer variables with no bounds default to [0, 1]? Reference keeps
        # [0, +inf) from the COLUMNS default; bounds only via BOUNDS section.
        return OptimizationProblem(
            offsets=offsets,
            indices=cols_flat[order],
            values=vals_flat[order],
            objective_coefficients=c,
            objective_offset=self.objective_offset,
            maximize=self.maximize,
            constraint_lower_bounds=lc,
            constraint_upper_bounds=uc,
            row_types=np.asarray(self.row_types, "U1"),
            rhs=rhs,
            variable_lower_bounds=lb,
            variable_upper_bounds=ub,
            variable_types=np.asarray(self.var_types, "U1"),
            problem_name=self.problem_name,
            objective_name=self.objective_name,
            variable_names=self.var_names,
            row_names=self.row_names,
        )


def parse_mps(path: str, fixed_format: bool = False,
              backend: str = "auto") -> OptimizationProblem:
    """Parse an MPS file into an OptimizationProblem.

    Mirrors reference parse_mps() (include/mps_parser/parser.hpp:35).

    backend: 'auto' (or 'native') parses with the native C++ parser
    (cpp/mps_parser/), built at first use; a failed build raises, it does
    not fall back. 'python' forces this module's pure-Python parser.
    """
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown MPS backend {backend!r}")
    if backend != "python":
        from cuopt_torch.io import native_mps

        return native_mps.parse_mps_native(path, fixed_format)
    with open(path, "r", errors="replace") as f:
        text = f.read()
    if not text.strip():
        raise MpsParseError(f"Empty MPS file: {path}")
    if not fixed_format:
        # Free-format tokenization handles the overwhelming majority of
        # files; names containing spaces require the fixed-column path, so
        # retry in fixed format on parse failure (the reference exposes an
        # explicit flag; we auto-fallback for convenience).
        try:
            return _parse_text(text, fixed_format=False)
        except MpsParseError:
            try:
                return _parse_text(text, fixed_format=True)
            except MpsParseError:
                raise
    return _parse_text(text, fixed_format=True)


def _parse_text(text: str, fixed_format: bool) -> OptimizationProblem:
    parser = _MpsParser(fixed_format)
    # First pass detects an OBJNAME directive; if it names a row other than
    # the first N row, re-parse with the directive pre-applied so COLUMNS/RHS
    # attribution is correct.
    probe = _MpsParser(fixed_format)
    for raw in text.splitlines():
        if raw and raw[0] not in " \t*$":
            toks = raw.split()
            if toks[0].upper() == "OBJNAME" and len(toks) > 1:
                probe.objname_directive = toks[1]
        elif probe.objname_directive is None and raw.strip() and (
            raw[0] in " \t"
        ):
            continue
    if probe.objname_directive is None:
        # OBJNAME value can also be on the following line
        lines = text.splitlines()
        for idx, raw in enumerate(lines):
            if raw and raw[0] not in " \t*$" and (
                raw.split()[0].upper() == "OBJNAME" and len(raw.split()) == 1
            ):
                for nxt in lines[idx + 1:]:
                    if nxt.strip() and nxt[0] not in "*$":
                        probe.objname_directive = nxt.split()[0]
                        break
                break
    if probe.objname_directive is not None:
        parser.objective_name = probe.objname_directive
        parser.objname_directive = probe.objname_directive

        # Pre-seeding objective_name means the first N row goes to free_rows
        # and entries are attributed to the OBJNAME row directly.
        def _seeded_parse_row(toks, raw, _orig=parser._parse_row):
            if toks[0].upper() == "N":
                parser.saw_rows = True
                if len(toks) < 2:
                    raise MpsParseError(f"Bad ROWS entry: {raw!r}")
                parser.free_rows.add(toks[1])
                return
            _orig(toks, raw)

        parser._parse_row = _seeded_parse_row
    prob = parser.parse(text)
    prob.validate()
    return prob


def ParseMps(path: str, fixed_format: bool = False):
    """Reference Python-package-compatible alias
    (python/cuopt/cuopt/linear_programming/cuopt_mps_parser/parser.py:135)."""
    return parse_mps(path, fixed_format)
