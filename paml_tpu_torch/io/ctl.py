"""Control-file reader compatible with the reference's `key = value`
format (reference: GetOptions in each program, e.g. src/codeml.c:1694;
`*` and `#` start comments; some values are structured, e.g.
'ndata 3 maintree 1').

Port of `paml_tpu/io/ctl.py` (pure Python): `codeml_spec`,
`baseml_spec`, `parse_step_matrix`, `yn00_opts` and the mcmctree
vocabulary `MCMCTREE_OPTS` (mcmctree reads its keys through `OptReader`);
pamp reads its keys through `read_ctl`, `resolve_path` and `_first_num`.
"""
from __future__ import annotations

import os
import re


def read_ctl(path: str) -> dict:
    """Parse a control file into {key: string_value} (values untyped)."""
    opts: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            # strip comments
            for cc in ("*", "#", "//"):
                idx = line.find(cc)
                if idx >= 0:
                    line = line[:idx]
            if "=" not in line:
                continue
            key, val = line.split("=", 1)
            key = key.strip()
            val = val.strip()
            if key:
                opts[key] = val
    return opts


# Reference option vocabularies (GetOptions tables).  Keys are matched
# like the reference: strncmp over the first 8 characters
# (src/codeml.c:1730, src/baseml.c:992, src/mcmctree.c:1523).
CODEML_OPTS = (
    "seqfile", "outfile", "treefile", "seqtype", "noisy", "ndata",
    "cleandata", "runmode", "method", "clock", "TipDate", "getSE",
    "RateAncestor", "CodonFreq", "estFreq", "verbose", "model", "hkyREV",
    "aaDist", "aaRatefile", "NSsites", "NShmm", "icode", "Mgene",
    "fix_kappa", "kappa", "fix_omega", "omega", "fix_alpha", "alpha",
    "Malpha", "ncatG", "fix_rho", "rho", "bootstrap", "Small_Diff",
    "fix_blength")        # src/codeml.c:1698-1704
BASEML_OPTS = (
    "seqfile", "outfile", "treefile", "noisy", "ndata", "cleandata",
    "verbose", "runmode", "method", "clock", "TipDate", "fix_rgene",
    "Mgene", "nhomo", "getSE", "RateAncestor", "model", "fix_kappa",
    "kappa", "fix_alpha", "alpha", "Malpha", "ncatG", "fix_rho", "rho",
    "nparK", "bootstrap", "Small_Diff", "icode", "fix_blength",
    "seqtype")            # src/baseml.c:958-962
MCMCTREE_OPTS = (
    "seed", "seqfile", "treefile", "outfile", "mcmcfile", "checkpoint",
    "BayesFactorBeta", "seqtype", "aaRatefile", "icode", "noisy",
    "usedata", "ndata", "duplication", "model", "clock", "TipDate",
    "RootAge", "fossilerror", "pfossilerror", "alpha", "ncatG",
    "cleandata", "BDparas", "kappa_gamma", "alpha_gamma", "rgene_gamma",
    "sigma2_gamma", "print", "burnin", "sampfreq", "nsample",
    "finetune")           # src/mcmctree.c:1499-1503
YN00_OPTS = (
    "seqfile", "outfile", "verbose", "noisy", "icode", "weighting",
    "commonkappa", "commonf3x4", "ndata")   # src/yn00.c:189-190
# keys that only control console verbosity / numeric epsilon; accepted
# and ignored in every program
_COSMETIC = ("noisy", "verbose", "Small_Diff")


class CtlError(ValueError):
    """An unrecognized or unsupported control-file option (the reference
    exits: 'option %s not recognised', src/codeml.c:1833)."""


def _match_opt(key: str, vocab) -> str | None:
    """Reference-style option matching: first 8 chars (strncmp ..., 8)."""
    for w in vocab:
        if key[:8] == w[:8]:
            return w
    return None


class OptReader:
    """Tracks which ctl keys a *_spec function consumed so leftovers can
    be rejected loudly instead of silently fitting a different model."""

    def __init__(self, opts: dict, program: str, vocab):
        self.opts = opts
        self.program = program
        self.vocab = vocab
        self.used: set[str] = set()

    def __call__(self, key, default=None):
        self.used.add(key[:8])
        return self.opts.get(key, self._prefix_get(key, default))

    def _prefix_get(self, key, default):
        for k, v in self.opts.items():
            if k[:8] == key[:8]:
                return v
        return default

    def require_off(self, key, what: str, off=(0,)):
        """Consume `key`; raise if its value requests behavior we don't
        implement (reference semantics would differ silently otherwise)."""
        v = self(key)
        if v is None:
            return
        try:
            val = _first_num(str(v))
        except Exception:
            raise CtlError(f"{self.program}: cannot parse option "
                           f"'{key} = {v}'")
        if val not in off:
            raise CtlError(
                f"{self.program}: option '{key} = {v}' requests {what}, "
                f"which paml_tpu_torch does not implement; refusing to fit a "
                f"different model silently")

    def finish(self):
        """Raise on unrecognized keys and on recognized keys that no code
        path consumed (a consumption bug would otherwise silently change
        the model, like the reference's aaDist/nhomo bug class)."""
        for k in self.opts:
            w = _match_opt(k, self.vocab)
            if w is None:
                raise CtlError(f"option {k!r} in the {self.program} ctl "
                               f"file not recognised")
            if k[:8] not in self.used and w not in _COSMETIC:
                raise CtlError(
                    f"{self.program}: option {k!r} is recognised but not "
                    f"consumed by paml_tpu_torch (refusing to ignore it "
                    f"silently)")
        for w in _COSMETIC:
            self.used.add(w[:8])


def _num(v: str):
    try:
        return int(v)
    except ValueError:
        return float(v)


def _first_num(v: str):
    m = re.match(r"[-+0-9.eE]+", v.strip())
    return _num(m.group(0)) if m else 0


def _ndata_mode(v: str) -> str:
    """'ndata = 3 [separate_trees | maintree [0|1]]' (reference:
    examples/ndata/README.txt, codeml.c:1739-1747)."""
    toks = str(v).split()
    if len(toks) < 2:
        return "shared"
    if toks[1].startswith("separate"):
        return "separate_trees"
    if toks[1].startswith("maintree"):
        return "maintree"
    return "shared"


def resolve_path(base_ctl: str, p: str) -> str:
    """Paths in ctl files are relative to the ctl file's directory."""
    if os.path.isabs(p):
        return p
    return os.path.normpath(os.path.join(os.path.dirname(
        os.path.abspath(base_ctl)), p))


CODON_FREQ_BY_INDEX = ["Fequal", "F1x4", "F3x4", "Fcodon",
                       "F1x4MG", "F3x4MG", "FMutSel0", "FMutSel"]
NUC_MODEL_BY_INDEX = ["JC69", "K80", "F81", "F84", "HKY85", "T92", "TN93",
                      "REV", "UNREST", "REVu", "UNRESTu"]


def parse_step_matrix(val: str, symmetric: bool):
    """The REVu / UNRESTu constraints after the model number: 'model = 9
    [2 (TA TC TG CA CG) (AG)]' -> (step [4, 4] with the 1-based rate index
    of each cell, 0 for the reference rate; nrate = 2) (reference:
    GetStepMatrix, src/baseml.c:912; base order TCAG).  REVu assigns the
    pairs symmetrically, UNRESTu by direction."""
    import numpy as np

    m = re.search(r"\[\s*(\d+)(.*)", val, re.S)
    if not m:
        raise ValueError("REVu/UNRESTu model needs '[nrate (pairs)...]' "
                         "after the model number")
    nrate = int(m.group(1))
    groups = re.findall(r"\(([^)]*)\)", m.group(2))
    if len(groups) != nrate:
        raise ValueError(f"expected {nrate} '(...)' rate groups, "
                         f"got {len(groups)}")
    code = {"T": 0, "C": 1, "A": 2, "G": 3, "U": 0}
    step = np.zeros((4, 4), dtype=np.int64)
    for i, grp in enumerate(groups):
        chars = [c for c in grp.upper() if c in code]
        if len(chars) % 2:
            raise ValueError(f"odd base count in rate group {i + 1}")
        for k in range(0, len(chars), 2):
            b1, b2 = code[chars[k]], code[chars[k + 1]]
            if b1 == b2:
                raise ValueError("diagonal pair in StepMatrix spec")
            step[b1, b2] = i + 1
            if symmetric:
                step[b2, b1] = i + 1
    return step, nrate


def baseml_spec(opts: dict, ctl_path: str):
    """(BasemlSpec, seqfile, treefile, outfile, extras) from a baseml
    control file."""
    from ..apps.baseml import BasemlSpec

    g = OptReader(opts, "baseml", BASEML_OPTS)
    model_raw = str(g("model", "0"))
    model_i = int(_first_num(model_raw))
    spec = BasemlSpec(
        model=NUC_MODEL_BY_INDEX[model_i],
        ncatG=int(_first_num(g("ncatG", "5"))),
        fix_alpha=bool(int(_first_num(g("fix_alpha", "1")))),
        alpha=float(_first_num(g("alpha", "0"))),
        # fix_kappa is an int: 2 selects label-defined branch kappa sets
        # under nhomo (reference: GetOptions, src/baseml.c:1046-1053)
        fix_kappa=int(_first_num(g("fix_kappa", "0"))),
        kappa=float(_first_num(g("kappa", "5"))),
        Mgene=int(_first_num(g("Mgene", "0"))),
        Malpha=bool(int(_first_num(g("Malpha", "0")))),
        cleandata=bool(int(_first_num(g("cleandata", "0")))),
        getSE=bool(int(_first_num(g("getSE", "0")))),
        clock=int(_first_num(g("clock", "0"))),
        nhomo=int(_first_num(g("nhomo", "0"))),
        nparK=int(_first_num(g("nparK", "0"))),
        fix_rho=bool(int(_first_num(g("fix_rho", "1")))),
        rho=float(_first_num(g("rho", "0"))),
    )
    if spec.model in ("REVu", "UNRESTu"):
        step, nrate = parse_step_matrix(model_raw,
                                        symmetric=spec.model == "REVu")
        spec.step_matrix = step
        spec.n_user_rates = nrate
    td = str(g("TipDate", "0")).split()
    if td and int(float(td[0])):
        spec.tipdate = True
        spec.tipdate_timeunit = float(td[1]) if len(td) > 1 else None
    if spec.nparK >= 1:
        # the reference coerces the rate-class HMM to fix alpha and rho
        # (src/baseml.c:1077): the nparK likelihood never uses them
        spec.fix_alpha = True
        spec.fix_rho = True
        spec.rho = 0.0
    if (spec.ncatG > 1 and spec.fix_alpha and spec.alpha == 0
            and not spec.nparK and spec.fix_rho and spec.rho == 0):
        # alpha = 0 fixed means no rate variation (reference semantics);
        # nparK models keep ncatG as the number of free rate classes
        spec.ncatG = 1
    extras = {
        "runmode": int(_first_num(g("runmode", "0"))),
        "clock": int(_first_num(g("clock", "0"))),
        "ndata": int(_first_num(g("ndata", "1"))),
        "RateAncestor": int(_first_num(g("RateAncestor", "0"))),
        "method": int(_first_num(g("method", "0"))),
        "nhomo": spec.nhomo,
    }
    g("icode")      # display-only (codon translation in rst output)
    g("seqfile"), g("treefile"), g("outfile")
    g.require_off("fix_blength", "fixed/proportional branch lengths in "
                  "baseml", off=(0, 1, -1))
    g.require_off("seqtype", "non-nucleotide baseml data types (5 RNA "
                  "editing / 4 binary)", off=(0,))
    g.require_off("fix_rgene", "fixed user-supplied gene rates")
    g.require_off("bootstrap", "bootstrap resampling output")
    g.finish()
    return (spec, resolve_path(ctl_path, g("seqfile")),
            resolve_path(ctl_path, g("treefile", "")),
            g("outfile", "mlb"), extras)


def codeml_spec(opts: dict, ctl_path: str):
    from ..apps.codeml import CodemlSpec

    g = OptReader(opts, "codeml", CODEML_OPTS)
    seqtype = int(_first_num(g("seqtype", "1")))
    aa_model_i = int(_first_num(g("model", "0")))
    spec = CodemlSpec(
        seqtype=seqtype,
        model=int(_first_num(g("model", "0"))) if seqtype == 1 else 0,
        NSsites=int(_first_num(g("NSsites", "0"))),
        codonf=CODON_FREQ_BY_INDEX[int(_first_num(g("CodonFreq", "2")))],
        icode=int(_first_num(g("icode", "0"))),
        ncatG=int(_first_num(g("ncatG", "3"))),
        fix_kappa=bool(int(_first_num(g("fix_kappa", "0")))),
        kappa=float(_first_num(g("kappa", "2"))),
        fix_omega=bool(int(_first_num(g("fix_omega", "0")))),
        omega=float(_first_num(g("omega", ".4"))),
        fix_alpha=bool(int(_first_num(g("fix_alpha", "1")))),
        alpha=float(_first_num(g("alpha", "0"))),
        cleandata=bool(int(_first_num(g("cleandata", "0")))),
        getSE=bool(int(_first_num(g("getSE", "0")))),
        hkyREV=bool(int(_first_num(g("hkyREV", "0")))),
        estFreq=bool(int(_first_num(g("estFreq", "0")))),
        Mgene=int(_first_num(g("Mgene", "0"))),
        clock=int(_first_num(g("clock", "0"))),
        fix_blength=int(_first_num(g("fix_blength", "0"))),
        aaDist=int(_first_num(g("aaDist", "0"))),
    )
    if spec.aaDist == 7 and seqtype == 1:
        # AAClasses reads OmegaAA.dat; the reference opens it from the
        # working directory (GetOmegaAA, src/codeml.c:4090) — example ctls
        # keep it next to the ctl file
        spec.omegaAA = resolve_path(ctl_path, "OmegaAA.dat")
    elif spec.aaDist and seqtype != 1:
        raise CtlError("codeml: aaDist with seqtype=2 (amino-acid "
                       "distance/class models) is not implemented")
    if seqtype in (2, 3):
        names = {0: "Poisson", 1: "EqualInput", 2: "Empirical",
                 3: "Empirical_F", 5: "FromCodon0", 6: "FromCodon",
                 8: "REVaa_0", 9: "REVaa"}
        spec.aa_model = names.get(aa_model_i, "Empirical_F")
        rf = g("aaRatefile")
        if rf:
            spec.aa_rate_file = resolve_path(ctl_path, rf)
    # NSsites may be a batch list: 'NSsites = 0 1 2 7 8'
    ns_list = [int(t) for t in re.findall(r"\d+", g("NSsites", "0"))]
    extras = {
        "runmode": int(_first_num(g("runmode", "0"))),
        "clock": int(_first_num(g("clock", "0"))),
        "ndata": int(_first_num(g("ndata", "1"))),
        "ndata_mode": _ndata_mode(g("ndata", "1")),
        "NSsites_list": ns_list,
        "RateAncestor": int(_first_num(g("RateAncestor", "0"))),
        "method": int(_first_num(g("method", "0"))),
    }
    g("aaRatefile")   # FromCodon/Empirical rate file (consumed above or n/a)
    g("seqfile"), g("treefile"), g("outfile")
    td = str(g("TipDate", "0")).split()
    if td and int(float(td[0])):
        spec.tipdate = True
        spec.tipdate_timeunit = float(td[1]) if len(td) > 1 else None
    g.require_off("NShmm", "the experimental NShmm site-class HMM")
    g.require_off("Malpha", "per-gene alpha values in codeml")
    g.require_off("fix_rho", "auto-discrete-gamma rates in codeml",
                  off=(1,))
    g.require_off("rho", "auto-discrete-gamma rates in codeml",
                  off=(0,))
    g.require_off("bootstrap", "bootstrap resampling output")
    g.finish()
    return (spec, resolve_path(ctl_path, g("seqfile")),
            resolve_path(ctl_path, g("treefile", "")),
            g("outfile", "mlc"), extras)


def yn00_opts(opts: dict, ctl_path: str):
    g = OptReader(opts, "yn00", YN00_OPTS)
    out = dict(
        seqfile=resolve_path(ctl_path, g("seqfile")),
        outfile=g("outfile", "yn"),
        icode=int(_first_num(g("icode", "0"))),
        weighting=bool(int(_first_num(g("weighting", "0")))),
        common_f3x4=bool(int(_first_num(g("commonf3x4", "0")))),
        ndata=int(_first_num(g("ndata", "1"))),
    )
    g.require_off("commonkappa", "a shared kappa across pairs")
    g.finish()
    return out
