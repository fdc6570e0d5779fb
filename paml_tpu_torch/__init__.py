"""paml_tpu_torch: `paml_tpu` in PyTorch — codeml (codon and amino-acid
data), baseml / basemlg, the pairwise programs, evolver's simulations and
the dating programs (mcmctree, infinitesites, clock 5 / 6 and the MCMC
utilities), as libraries and as `python -m paml_tpu_torch <program>` —
with the pruning kernels written in CUDA C++ for Hopper.

Importing the package has no side effects: it imports neither JAX nor
`paml_tpu`, builds nothing and touches no device.  The kernels are built
from `csrc/` at their first launch on a CUDA tensor (`_build.py`).
"""
