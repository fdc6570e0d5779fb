"""paml_tpu_torch: the codon maximum-likelihood fit of `paml_tpu` in
PyTorch, with the fused pruning kernels written in CUDA C++ for Hopper.

Importing the package has no side effects: it imports neither JAX nor
`paml_tpu`, builds nothing and touches no device.  The kernels are built
from `csrc/` at their first launch on a CUDA tensor (`_build.py`).
"""
