"""Alignment reading and site-pattern compression.

Port of `paml_tpu/io/seqio.py` (numpy only): the PAML/PHYLIP reader
(sequential and interleaved, with the ``G I S P C`` option characters),
FASTA and basic NEXUS, several alignments stacked in one file
(`read_alignments`, which also reads mcmctree's continuous
morphological characters into `MorphAlignment`), the nucleotide, codon
and amino-acid state-set encoders, the translation of codons to amino
acids, and `pack`, the pattern compression of the reference's
`PatternWeight` (src/treesub.c:1386).

Every site is held as a state-set bitmask over model states; tip partials
fall directly out of the bitmask (unnormalized indicator sums).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from ..constants import (AA_AMBIG, AA_ORDER, NUC_AMBIG, NUC_ORDER,
                         geneticcode_table, sense_codons)

BASE_SEQ, CODON_SEQ, AA_SEQ, CODON2AA_SEQ = 0, 1, 2, 3


@dataclass
class Alignment:
    """Raw alignment: characters, before encoding/compression."""
    names: list[str]
    rows: list[str]             # [ns] strings, length ls (nucleotides for codon data)
    seqtype: int
    ngene: int = 1
    site_gene: np.ndarray | None = None   # [nunits] gene id per site unit
    # pattern input (option P): precompressed patterns with counts
    pattern_counts: np.ndarray | None = None

    @property
    def ns(self) -> int:
        return len(self.names)

    @property
    def ls(self) -> int:
        return len(self.rows[0])


@dataclass
class MorphAlignment:
    """Continuous morphological characters (mcmctree option M locus)."""
    names: list
    z: np.ndarray            # [ns, ls]
    popvar: float = 0.0
    ldetRm: float = 0.0
    seqtype: int = 3         # MORPHC-style marker

    @property
    def ns(self):
        return len(self.names)


@dataclass
class PackedData:
    """Compressed, encoded data ready for the likelihood engine."""
    names: list[str]
    seqtype: int
    nstates: int
    # tip state-sets as float partials: [ns, npatt, nstates] in {0,1}
    tip_partials: np.ndarray
    fpatt: np.ndarray           # [npatt] pattern counts (float)
    ngene: int = 1
    posG: np.ndarray = field(default_factory=lambda: np.array([0, 0]))  # gene block boundaries, len ngene+1
    lgene: np.ndarray | None = None      # sites per gene
    ls: int = 0                  # total site units
    cleandata: bool = True
    # per-pattern representative site index (for site-wise outputs)
    pattern_site: np.ndarray | None = None
    # map site -> pattern index
    site_pattern: np.ndarray | None = None
    base_freqs: np.ndarray | None = None   # observed freqs over all seqs
    gene_freqs: np.ndarray | None = None   # [ngene, nstates] per-gene observed
    # codon data: raw per-position nucleotide state sets [ns, npatt, 3, 4]
    pos_masks: np.ndarray | None = None
    icode: int = 0

    def gene_slice(self, g: int) -> slice:
        return slice(int(self.posG[g]), int(self.posG[g + 1]))

    @property
    def ns(self) -> int:
        return self.tip_partials.shape[0]

    @property
    def npatt(self) -> int:
        return self.tip_partials.shape[1]


# ---------------------------------------------------------------------------
# raw file reading
# ---------------------------------------------------------------------------

def _is_blank(line: str) -> bool:
    return not any(c.isalnum() for c in line)


def read_alignments(path: str, seqtype: int = BASE_SEQ,
                    ndata: int | None = None) -> list:
    """Read several alignments stacked in one file (the reference's `ndata`
    loop and mcmctree's loci): PAML/PHYLIP blocks, or `MorphAlignment`
    for a block whose header carries M."""
    with open(path) as f:
        lines = f.read().splitlines()
    # header lines: first two tokens are ints, remaining are option
    # letters; a morphological locus adds numbers after 'M'
    # ('ns ls M popvar ldetRm', reference: src/treesub.c:552-556)
    starts = []
    for i, line in enumerate(lines):
        toks = line.split()
        if len(toks) < 2 or not (toks[0].isdigit() and toks[1].isdigit()):
            continue
        rest = toks[2:]
        letters = [t for t in rest if re.fullmatch(r"[A-Za-z]+", t)]
        numbers = [t for t in rest
                   if re.fullmatch(r"[-+0-9.eE]+", t)]
        if len(letters) + len(numbers) == len(rest) and (
                not numbers or any("M" in t.upper() for t in letters)):
            starts.append(i)
    if not starts:
        raise ValueError(f"no alignment headers found in {path}")
    if ndata is not None:
        starts = starts[:ndata]
    out = []
    for k, s in enumerate(starts):
        end = starts[k + 1] if k + 1 < len(starts) else len(lines)
        block = "\n".join(lines[s:end])
        toks = lines[s].split()
        if any("M" in t.upper() for t in toks[2:]
               if re.fullmatch(r"[A-Za-z]+", t)):
            out.append(_read_morphology(block))
        else:
            out.append(_read_phylip(block, seqtype))
    return out


def _read_morphology(text: str) -> MorphAlignment:
    """Continuous-character block: 'ns ls M [popvar [ldetRm]]' then per
    species a name and ls values (reference: ReadMorphology,
    src/treesub.c:436)."""
    toks = text.split()
    ns, ls = int(toks[0]), int(toks[1])
    i = 2
    if "M" not in toks[i].upper():
        raise ValueError(f"morphology header without M: {toks[:3]}")
    i += 1
    extras = []
    while i < len(toks) and re.fullmatch(r"[-+0-9.eE]+", toks[i]) \
            and len(extras) < 2:
        extras.append(float(toks[i]))
        i += 1
    popvar = extras[0] if extras else 0.0
    ldetRm = extras[1] if len(extras) > 1 else 0.0
    names, z = [], np.zeros((ns, ls))
    for s in range(ns):
        names.append(toks[i])
        i += 1
        for j in range(ls):
            z[s, j] = float(toks[i])
            i += 1
    return MorphAlignment(names=names, z=z, popvar=popvar, ldetRm=ldetRm)


def read_alignment(path: str, seqtype: int = BASE_SEQ) -> Alignment:
    """Autodetect PAML/PHYLIP vs FASTA vs NEXUS (reference: GetSeqFileType,
    src/treesub.c:367) and parse."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith(">"):
        return _read_fasta(stripped, seqtype)
    low = text.lower()
    first_tok = stripped.split()[:2]
    is_phylip = (len(first_tok) == 2 and first_tok[0].isdigit()
                 and first_tok[1].isdigit())
    if is_phylip:
        return _read_phylip(text, seqtype)
    if "begin data" in low or "#nexus" in low:
        return _read_nexus(text, seqtype)
    raise ValueError(f"unrecognized sequence file format: {path}")


def _read_fasta(text: str, seqtype: int) -> Alignment:
    names, rows = [], []
    for block in text.split(">")[1:]:
        lines = block.splitlines()
        names.append(lines[0].split()[0] if lines[0].split() else "")
        rows.append("".join(c for l in lines[1:] for c in l if not c.isspace()).upper())
    if len({len(r) for r in rows}) != 1:
        raise ValueError("fasta sequences are not aligned (unequal lengths)")
    return Alignment(names, rows, seqtype)


def _read_nexus(text: str, seqtype: int) -> Alignment:
    low = text.lower()
    m = re.search(r"ntax\s*=\s*(\d+)", low)
    ns = int(m.group(1))
    m = re.search(r"nchar\s*=\s*(\d+)", low)
    ls = int(m.group(1))
    start = low.index("matrix") + len("matrix")
    end = low.index(";", start)
    body = text[start:end]
    names: list[str] = []
    rows: dict[str, str] = {}
    for line in body.splitlines():
        line = re.sub(r"\[.*?\]", "", line).strip()
        if not line:
            continue
        parts = line.split(None, 1)
        if len(parts) != 2:
            continue
        name, seq = parts
        seq = "".join(seq.split()).upper()
        if name not in rows:
            names.append(name)
            rows[name] = ""
        rows[name] += seq
    rows_l = [rows[n] for n in names]
    if len(names) != ns or any(len(r) != ls for r in rows_l):
        raise ValueError("nexus matrix dimensions disagree with ntax/nchar")
    return Alignment(names, rows_l, seqtype)


_SEQ_CHARS_NUC = set(NUC_AMBIG) | {"."}
_SEQ_CHARS_AA = set(AA_AMBIG) | {"."}


def _read_phylip(text: str, seqtype: int) -> Alignment:
    """PAML/PHYLIP main format with option characters on the header line
    (reference: src/treesub.c:549-696)."""
    lines = text.splitlines()
    header = lines[0].split()
    ns, ls = int(header[0]), int(header[1])
    opts = "".join(header[2:]).upper()
    n31 = 3 if seqtype in (CODON_SEQ, CODON2AA_SEQ) else 1
    nunits = ls // n31
    if ls % n31:
        raise ValueError(f"{ls} nucleotides, not a multiple of 3")
    sequential = "I" not in opts
    readpattern = "P" in opts
    coding = "C" in opts
    n_optlines = opts.count("G")

    pos = 1
    ngene, site_gene, lgene = 1, None, None
    if coding:
        # 'GC' on the header line: protein-coding DNA, 3 codon-position
        # genes — for NUCLEOTIDE analyses only; codon/AA readers ignore C
        # (reference: ReadSeq, src/treesub.c:595-608 gates on seqtype==0)
        n_optlines -= 1
        if seqtype == BASE_SEQ:
            ngene, site_gene = 3, np.arange(nunits) % 3

    for _ in range(n_optlines):
        # option line: 'G ngene [len1 len2 ...]'
        while pos < len(lines) and _is_blank(lines[pos]):
            pos += 1
        toks = lines[pos].split()
        assert toks[0].upper().startswith("G"), f"bad option line: {lines[pos]}"
        rest: list[str]
        if len(toks) >= 2:
            ngene, rest = int(toks[1]), toks[2:]
        else:
            pos += 1
            t2 = lines[pos].split()
            ngene, rest = int(t2[0]), t2[1:]
        pos += 1
        if rest:
            # per-gene lengths, possibly continued on following lines
            vals = [int(t) for t in rest]
            while len(vals) < ngene:
                vals += [int(t) for t in lines[pos].split()]
                pos += 1
            lgene = np.array(vals[:ngene])
            if lgene.sum() != nunits:
                raise ValueError("option G: total length over genes is not correct")
            site_gene = np.repeat(np.arange(ngene), lgene)
        else:
            # per-site gene marks: digits 1..ngene over subsequent lines
            marks: list[int] = []
            while len(marks) < nunits:
                if ngene > 9:
                    marks += [int(t) for t in lines[pos].split()]
                else:
                    marks += [int(c) for c in lines[pos] if c.isdigit()]
                pos += 1
            site_gene = np.array(marks[:nunits]) - 1
            if site_gene.min() < 0 or site_gene.max() >= ngene:
                raise ValueError("bad gene mark")

    valid = _SEQ_CHARS_NUC if seqtype != AA_SEQ else _SEQ_CHARS_AA
    names: list[str] = []
    rows: list[str] = []

    def parse_seq_chars(chunk: str, out: list[str], first_row: str | None):
        for c in chunk:
            cu = c.upper()
            if cu == "U" and seqtype != AA_SEQ:
                cu = "T"
            if cu == ".":
                if first_row is None:
                    raise ValueError(". in first sequence")
                out.append(first_row[len(out)])
            elif cu in valid:
                out.append(cu)
            elif cu.isalpha():
                raise ValueError(f"unrecognized character {c!r} in sequence")
            # digits / spaces / punctuation silently skipped (reference behavior)

    if sequential:
        for j in range(ns):
            while pos < len(lines) and _is_blank(lines[pos]):
                pos += 1
            line = lines[pos]
            pos += 1
            if line[:1] in ("=", ">"):
                line = line[1:]
            line = line.lstrip()
            # name ends at two consecutive spaces, else first 30 chars (or the
            # whole line if shorter) -- reference rule, src/treesub.c:700-711
            cut = line.find("  ")
            if 0 < cut < 30:
                name, rest = line[:cut], line[cut:]
            elif len(line.rstrip()) <= 30:
                name, rest = line.rstrip(), ""
            else:
                name, rest = line[:30], line[30:]
            names.append(name.strip())
            chars: list[str] = []
            parse_seq_chars(rest, chars, rows[0] if j else None)
            while len(chars) < ls:
                if pos >= len(lines):
                    raise ValueError(f"EOF at site {len(chars) + 1}, seq {j + 1}")
                parse_seq_chars(lines[pos], chars, rows[0] if j else None)
                pos += 1
            rows.append("".join(chars[:ls]))
    else:
        # interleaved: first block has names; position-marker lines (pure
        # digits) before a block are skipped (reference: hasbase check,
        # src/treesub.c:760)
        def has_base(l: str) -> bool:
            return any(c in ".-?" or c.isalpha() for c in l)

        filled = [0] * ns
        chars_all: list[list[str]] = [[] for _ in range(ns)]
        block = 0
        while min(filled) < ls:
            for j in range(ns):
                if filled[j] >= ls and block > 0:
                    continue
                while pos < len(lines) and _is_blank(lines[pos]):
                    pos += 1
                if pos >= len(lines):
                    raise ValueError(f"EOF in interleaved block {block}, seq {j + 1}")
                line = lines[pos]
                pos += 1
                if j == 0 and block > 0:
                    while not has_base(line):
                        while pos < len(lines) and _is_blank(lines[pos]):
                            pos += 1
                        line = lines[pos]
                        pos += 1
                if block == 0:
                    line = line.lstrip()
                    cut = line.find("  ")
                    if 0 < cut < 30:
                        name, rest = line[:cut], line[cut:]
                    elif len(line.rstrip()) <= 30:
                        name, rest = line.rstrip(), ""
                    else:
                        name, rest = line[:30], line[30:]
                    names.append(name.strip())
                    line = rest
                parse_seq_chars(line, chars_all[j],
                                "".join(chars_all[0]) if j else None)
                filled[j] = len(chars_all[j])
            block += 1
        rows = ["".join(c[:ls]) for c in chars_all]

    aln = Alignment(names, rows, seqtype, ngene=ngene, site_gene=site_gene)
    if readpattern:
        # pattern counts follow the sequences
        counts: list[float] = []
        while pos < len(lines) and len(counts) < nunits:
            counts += [float(t) for t in lines[pos].split()]
            pos += 1
        aln.pattern_counts = np.array(counts[:nunits])
    return aln


# ---------------------------------------------------------------------------
# encoding: characters -> state-set masks
# ---------------------------------------------------------------------------

def _nuc_masks(row: str) -> np.ndarray:
    """[ls, 4] bool state-set per nucleotide site."""
    out = np.zeros((len(row), 4), dtype=bool)
    for i, c in enumerate(row):
        for s in NUC_AMBIG[c]:
            out[i, NUC_ORDER.index(s)] = True
    return out


_NUC_LUT = None


def _nuc_lut():
    global _NUC_LUT
    if _NUC_LUT is None:
        lut = np.zeros((128, 4), dtype=bool)
        for c, states in NUC_AMBIG.items():
            for s in states:
                lut[ord(c), NUC_ORDER.index(s)] = True
        _NUC_LUT = lut
    return _NUC_LUT


def encode_nuc(rows: list[str]) -> np.ndarray:
    """[ns, ls, 4] bool."""
    lut = _nuc_lut()
    arr = np.frombuffer("".join(rows).encode(), dtype=np.uint8).reshape(len(rows), -1)
    return lut[arr]


def encode_aa(rows: list[str]) -> np.ndarray:
    """[ns, ls, 20] bool."""
    lut = np.zeros((128, 20), dtype=bool)
    for c, states in AA_AMBIG.items():
        for s in states:
            lut[ord(c), AA_ORDER.index(s)] = True
    arr = np.frombuffer("".join(rows).encode(), dtype=np.uint8).reshape(len(rows), -1)
    return lut[arr]


def encode_codon(rows: list[str], icode: int = 0, return_pos=False):
    """[ns, ls/3, nsense] bool: possible sense codons per codon site.

    Ambiguity semantics follow the reference (CharaMap / CodonListall):
    the state set is the cartesian product of per-position nucleotide sets,
    with stop codons removed.
    """
    nuc = encode_nuc(rows)                      # [ns, ls, 4]
    ns, ls, _ = nuc.shape
    n_cod = ls // 3
    p1 = nuc[:, 0::3, :][:, :n_cod]
    p2 = nuc[:, 1::3, :][:, :n_cod]
    p3 = nuc[:, 2::3, :][:, :n_cod]
    # outer product over the three positions -> [ns, ncod, 4,4,4] -> 64
    m = (p1[:, :, :, None, None] & p2[:, :, None, :, None]
         & p3[:, :, None, None, :]).reshape(ns, n_cod, 64)
    sense = sense_codons(icode)
    stops = np.setdiff1d(np.arange(64), sense)
    if m[:, :, stops].any():
        # a fully resolved stop codon is an error; ambiguous sets just drop stops
        bad = m[:, :, stops].any(-1) & (m.sum(-1) == 1)
        if bad.any():
            i, j = np.argwhere(bad)[0]
            raise ValueError(f"stop codon at seq {i + 1}, codon site {j + 1}")
    if return_pos:
        return m[:, :, sense], np.stack([p1, p2, p3], axis=2)
    return m[:, :, sense]


def translate_codon_rows(rows: list[str], icode: int = 0) -> list[str]:
    """Translate protein-coding DNA to amino acids (reference: DNA2protein,
    src/tools.c:814).  Ambiguous codons become 'X'."""
    tab = geneticcode_table(icode)
    out = []
    for row in rows:
        aas = []
        for i in range(0, len(row) - 2, 3):
            cod = row[i:i + 3].upper().replace("U", "T")
            if all(c in "TCAG" for c in cod):
                idx = 16 * NUC_ORDER.index(cod[0]) + 4 * NUC_ORDER.index(cod[1]) + NUC_ORDER.index(cod[2])
                aa = tab[idx]
                aas.append(AA_ORDER[aa] if aa >= 0 else "*")
            else:
                aas.append("X")
        out.append("".join(aas))
    return out


# ---------------------------------------------------------------------------
# pattern compression
# ---------------------------------------------------------------------------

def pack(aln: Alignment, cleandata: bool = False, icode: int = 0) -> PackedData:
    """Encode + compress into site patterns (reference: PatternWeight,
    src/treesub.c:1386 and EncodeSeqs :1116)."""
    seqtype = aln.seqtype
    pos_masks_full = None
    if seqtype == BASE_SEQ:
        masks = encode_nuc(aln.rows)
    elif seqtype == CODON_SEQ:
        masks, pos_masks_full = encode_codon(aln.rows, icode, return_pos=True)
    elif seqtype == AA_SEQ:
        masks = encode_aa(aln.rows)
    elif seqtype == CODON2AA_SEQ:
        masks = encode_aa(translate_codon_rows(aln.rows, icode))
    else:
        raise ValueError(f"seqtype {seqtype}")
    ns, nunits, nstates = masks.shape

    site_gene = aln.site_gene
    if site_gene is None:
        site_gene = np.zeros(nunits, dtype=np.int64)
    ngene = aln.ngene

    keep = np.ones(nunits, dtype=bool)
    if cleandata:
        # drop sites where any sequence is ambiguous (reference: RemoveIndel)
        keep = (masks.sum(-1) == 1).all(axis=0)
    masks = masks[:, keep]
    if pos_masks_full is not None:
        pos_masks_full = pos_masks_full[:, keep]
    site_gene = site_gene[keep]
    counts_in = aln.pattern_counts[keep] if aln.pattern_counts is not None else None
    nunits = int(keep.sum())

    # group identical columns within each gene
    # column signature: bytes of the bool mask across all species
    flat = np.packbits(masks.transpose(1, 0, 2).reshape(nunits, -1), axis=1)
    order = np.arange(nunits)
    tip_list, fpatt_list, psite_list, posG = [], [], [], [0]
    site_pattern = np.zeros(nunits, dtype=np.int64)
    lgene = np.zeros(ngene, dtype=np.int64)
    for g in range(ngene):
        sel = order[site_gene == g]
        lgene[g] = len(sel)
        if len(sel) == 0:
            posG.append(posG[-1])
            continue
        cols = flat[sel]
        uniq, first_idx, inv = np.unique(cols, axis=0, return_index=True,
                                         return_inverse=True)
        npat_g = uniq.shape[0]
        if counts_in is not None:
            w = np.bincount(inv, weights=counts_in[sel], minlength=npat_g)
        else:
            w = np.bincount(inv, minlength=npat_g).astype(float)
        rep_sites = sel[first_idx]
        tip_list.append(masks[:, rep_sites])
        fpatt_list.append(w)
        psite_list.append(rep_sites)
        site_pattern[sel] = posG[-1] + inv
        posG.append(posG[-1] + npat_g)

    tip = np.concatenate(tip_list, axis=1).astype(np.float64)
    fpatt = np.concatenate(fpatt_list)
    pattern_site_all = np.concatenate(psite_list)
    pos_masks = (pos_masks_full[:, pattern_site_all]
                 if pos_masks_full is not None else None)
    # observed frequencies (reference: InitializeBaseAA/AddFreqSeqGene,
    # src/treesub.c:1548/:1712): counts pooled over species, with ambiguity
    # characters distributed over their state sets in proportion to the
    # current frequencies and iterated to a fixed point (<=20 rounds).
    # Stage 1 seeds per-gene estimates with the mean of per-species EM
    # frequencies; stage 3 seeds the overall estimate with the gene mean.
    resolved = tip.sum(-1) == 1
    w = tip * (resolved[..., None] * fpatt[None, :, None])      # [ns,H,n]

    def _em(block_tip, block_fpatt, pi0, pooled_axis):
        """EM frequency counts for one (species x patterns) block; ambiguous
        characters resolved against pi (reference: AddFreqSeqGene)."""
        res = block_tip.sum(-1) == 1
        base = (block_tip * (res * block_fpatt[None, :])[..., None]
                ).sum(pooled_axis)                              # [n]
        ambm = (~res) & (block_tip.sum(-1) > 1)
        amb = block_tip[ambm]                                   # [M, n]
        wamb = np.broadcast_to(block_fpatt[None, :],
                               block_tip.shape[:2])[ambm]       # [M]
        pi = np.asarray(pi0, dtype=np.float64)
        for _ in range(20):
            if amb.shape[0]:
                c = pi[None, :] * amb
                c = c / np.maximum(c.sum(-1, keepdims=True), 1e-300)
                cnt = base + (c * wamb[:, None]).sum(0)
            else:
                cnt = base
            tot = cnt.sum()
            newpi = cnt / tot if tot > 1e-10 else np.full(nstates,
                                                          1.0 / nstates)
            if np.sqrt(((newpi - pi) ** 2).sum()) < 1e-8:
                pi = newpi
                break
            pi = newpi
        return pi

    posG_arr = np.array(posG)
    all_resolved = bool(resolved.all())
    gene_freqs = []
    for g in range(ngene):
        sl = slice(posG_arr[g], posG_arr[g + 1])
        blk, fp = tip[:, sl], fpatt[sl]
        # per-species average (the reference's piG seed)
        per_sp = []
        for js in range(len(aln.names)):
            per_sp.append(_em(blk[js:js + 1], fp,
                              np.full(nstates, 1.0 / nstates), (0, 1)))
        seed = np.mean(per_sp, axis=0)
        gene_freqs.append(seed if all_resolved else _em(blk, fp, seed,
                                                        (0, 1)))
    gene_freqs = np.stack(gene_freqs)
    if all_resolved:
        lg = (lgene if lgene is not None
              else np.array([fpatt[posG_arr[g]:posG_arr[g + 1]].sum()
                             for g in range(ngene)]))
        base_freqs = (gene_freqs * (np.asarray(lg, dtype=float)
                                    / float(sum(lg)))[:, None]).sum(0)
    else:
        base_freqs = _em(tip, fpatt, gene_freqs.mean(0), (0, 1))

    return PackedData(
        names=aln.names, seqtype=seqtype, nstates=nstates,
        tip_partials=tip, fpatt=fpatt, ngene=ngene,
        posG=np.array(posG), lgene=lgene, ls=nunits,
        cleandata=cleandata or bool((masks.sum(-1) == 1).all()),
        pattern_site=pattern_site_all,
        site_pattern=site_pattern, base_freqs=base_freqs,
        gene_freqs=gene_freqs, pos_masks=pos_masks, icode=icode)
