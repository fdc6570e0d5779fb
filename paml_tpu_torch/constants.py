"""Character orderings, ambiguity maps and genetic codes.

Copy of `paml_tpu/constants.py` (numpy only).  State orderings follow the
reference conventions (src/tools.c:15-22: T,C,A,G nucleotides; A,R,N,D,...
amino acids); the genetic codes are the NCBI translation tables indexed by
``icode`` 0..10, as 64-character strings in TCAG codon order.
"""
from __future__ import annotations

import numpy as np

# --- nucleotides ---------------------------------------------------------
# Index order T=0, C=1, A=2, G=3 (reference convention, src/tools.c:15).
NUC_ORDER = "TCAG"

# IUPAC ambiguity codes -> set of plain states (indices into NUC_ORDER).
# 'U' is treated as 'T'.  '-', 'N', '?' mean fully ambiguous.
NUC_AMBIG: dict[str, str] = {
    "T": "T", "C": "C", "A": "A", "G": "G", "U": "T",
    "Y": "TC", "R": "AG", "M": "CA", "K": "TG", "S": "CG", "W": "TA",
    "H": "TCA", "B": "TCG", "V": "CAG", "D": "TAG",
    "-": "TCAG", "N": "TCAG", "?": "TCAG", ".": "TCAG", "*": "TCAG",
}

# --- amino acids ---------------------------------------------------------
# Index order (reference convention, src/tools.c:18).
AA_ORDER = "ARNDCQEGHILKMFPSTWYV"

AA_AMBIG: dict[str, str] = {aa: aa for aa in AA_ORDER}
AA_AMBIG.update({
    "B": "ND", "Z": "QE", "J": "IL",
    "X": AA_ORDER, "-": AA_ORDER, "?": AA_ORDER, ".": AA_ORDER, "*": AA_ORDER,
})

# --- genetic codes -------------------------------------------------------
# 64-char strings in TCAG codon order (codon index = 16*b1 + 4*b2 + b3 with
# T=0,C=1,A=2,G=3).  '*' marks a stop codon.  Derived from the public NCBI
# translation tables; the icode numbering matches the reference
# (src/tools.c:23-88): 0 universal, 1 vertebrate mt, 2 yeast mt, 3 mold mt,
# 4 invertebrate mt, 5 ciliate nuclear, 6 echinoderm mt, 7 euplotid mt,
# 8 alternative yeast nuclear, 9 ascidian mt, 10 blepharisma nuclear.
GENETIC_CODES: dict[int, str] = {
    0: "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    1: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
    2: "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    3: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    4: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
    5: "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    6: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    7: "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    8: "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    9: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
    10: "FFLLSSSSYY*QCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
}


def codon_string(idx: int) -> str:
    """Codon index (0..63, TCAG order) -> 3-letter codon string."""
    return NUC_ORDER[idx // 16] + NUC_ORDER[(idx // 4) % 4] + NUC_ORDER[idx % 4]


def codon_index(codon: str) -> int:
    b = [NUC_ORDER.index(c) for c in codon.upper().replace("U", "T")]
    return 16 * b[0] + 4 * b[1] + b[2]


def geneticcode_table(icode: int) -> np.ndarray:
    """Return int array [64]: amino-acid index per codon, -1 for stop."""
    s = GENETIC_CODES[icode]
    return np.array([-1 if c == "*" else AA_ORDER.index(c) for c in s], dtype=np.int32)


def sense_codons(icode: int) -> np.ndarray:
    """Indices (into 0..63) of non-stop codons, ascending (reference:
    setmark_61_64, src/treesub.c:2329)."""
    tab = geneticcode_table(icode)
    return np.where(tab >= 0)[0].astype(np.int32)
