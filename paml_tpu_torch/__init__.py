"""paml_tpu_torch: codeml for codon data and baseml / basemlg for
nucleotide data of `paml_tpu` in PyTorch (the fits, standard errors,
NEB/BEB, ancestral reconstruction and the `python -m paml_tpu_torch
codeml|baseml|basemlg` programs), with the pruning kernels written in CUDA
C++ for Hopper.

Importing the package has no side effects: it imports neither JAX nor
`paml_tpu`, builds nothing and touches no device.  The kernels are built
from `csrc/` at their first launch on a CUDA tensor (`_build.py`).
"""
