"""Tips coded for the pruning kernels: int32 codes and an ambiguity table.

A tip cell is a vector over the n states: one-hot for a resolved codon, a
set of codons for an ambiguous one (all ones for a gap, the codons that a
codon with an N allows), or any partial.  `TipCodes` keeps codes [ns, H]
(int32): a code below n is the state of a one-hot cell, a code n + a names
row a of `amb` [A, n], the distinct cell vectors that are not one-hot.
`dense` expands the codes back to the [ns, H, n] partials bit for bit, so
whatever takes coded tips computes the same function on the same inputs;
with A = 0 the codes are plain state codes.

The CUDA kernels gather a tip's contribution from P (a state) or from the
table P amb^T (an ambiguity) instead of a product per tip
(`csrc/pruning.cu`); the plain versions take the dense partials.  That
table holds ns x C x 64 x A values (A rounded up to 32) on the card, and
the kernels refuse one of more than an eighth of the card's memory
(`cuda_pruning.check_tip_table`): gapped codon data has a few hundred
rows, but soft partials, every cell distinct (A up to ns x H), do not fit
at realistic sizes and are left to the plain versions.
"""
from __future__ import annotations

import torch


class TipCodes:
    """codes [ns, H] int32 and amb [A, n] (see the module docstring)."""

    # shards: the pattern mesh's slices of these tips, made once
    # (`pruning.class_site_lnf` under `set_pattern_mesh`)
    __slots__ = ("codes", "amb", "shards")

    def __init__(self, codes: torch.Tensor, amb: torch.Tensor):
        self.codes, self.amb = codes, amb
        self.shards = None

    @property
    def n_amb(self) -> int:
        return self.amb.shape[0]

    def dense(self, dtype=None) -> torch.Tensor:
        """The partials [ns, H, n] (in `dtype`, default amb's)."""
        amb = self.amb if dtype is None else self.amb.to(dtype)
        eye = torch.eye(amb.shape[1], dtype=amb.dtype, device=amb.device)
        return torch.cat([eye, amb])[self.codes.long()]

    def split(self, w: int) -> list[TipCodes]:
        """Chunks of w patterns, each with contiguous codes and the whole
        table."""
        return [TipCodes(c.contiguous(), self.amb)
                for c in self.codes.split(w, dim=1)]

    def to(self, device, dtype=None) -> TipCodes:
        return TipCodes(self.codes.to(device),
                        self.amb.to(device=device, dtype=dtype))


def encode(part) -> TipCodes:
    """TipCodes of partials [ns, H, n] (a tensor, on its device, or a numpy
    array): a cell is a state when exactly one of its values is nonzero and
    that value is 1; the other cells' distinct vectors form amb, the gap
    (all ones) first, then the rest in lexicographic order."""
    part = torch.as_tensor(part)
    ns, H, n = part.shape
    flat = part.reshape(-1, n)
    one = ((flat != 0).sum(-1) == 1) & (flat.amax(-1) == 1)
    codes = flat.argmax(-1)
    tables = []
    other = ~one
    if bool(other.any()):
        rows = flat[other]
        # gaps are most ambiguous cells of real alignments: one table row
        # for all of them, so that only the few others are sorted
        gap = (rows.amin(-1) == 1) & (rows.amax(-1) == 1)
        inv = torch.zeros_like(codes[:rows.shape[0]])
        if bool(gap.any()):
            tables.append(torch.ones_like(rows[:1]))
        if not bool(gap.all()):
            uniq, u_inv = torch.unique(rows[~gap], dim=0, return_inverse=True)
            inv[~gap] = len(tables) + u_inv
            tables.append(uniq)
        codes[other] = n + inv
    amb = torch.cat(tables) if tables else flat.new_zeros((0, n))
    return TipCodes(codes.to(torch.int32).reshape(ns, H), amb)
