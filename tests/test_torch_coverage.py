"""Every top-level name of every paml_tpu module exists in its
paml_tpu_torch counterpart (by `ast`, no import): the same name, or the
renamed counterpart of RENAMED; the only exceptions are the TPU- and
JAX-only machinery of NOT_PORTED, each with its reason (ROADMAP B7), and
the JAX package's dead code of NO_CALLER, which nothing in paml_tpu or
its tests calls.  Each exception must still be missing from the port,
so the list cannot outlive the gap it records."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT = ROOT / "paml_tpu", ROOT / "paml_tpu_torch"

# whole modules with no counterpart
NOT_PORTED_MODULES = {
    "core/pallas_pruning.py": "the Pallas kernels B1/B2 and their TPU "
    "tiling; ported as CUDA C++ (csrc/pruning.cu) behind core/cuda_pruning",
    "core/pallas_pruning_big.py": "the Pallas kernels B3/B4 and their DMA "
    "rings; ported as CUDA C++ (csrc/pruning_big.cu) behind "
    "core/cuda_pruning",
    "data/__init__.py": "an empty file: the port's data directory holds "
    "the matrices alone",
}

# module -> {name: reason}
NOT_PORTED = {
    "__init__.py": {
        "_enable_compilation_cache": "the XLA compile cache",
    },
    "__main__.py": {
        "_init_jax_backend": "JAX backend selection and the XLA cache",
    },
    "apps/codeml.py": {
        "_select_branch_type": "a static-index workaround for XLA's TPU "
        "gather; the port indexes P by branch type inline",
    },
    "core/optim.py": {
        "maximize_policy": "an f32 stage on the chip and an f64 polish on "
        "the host, because the TPU emulates f64",
        "maximize_auto": "selects maximize_policy on an accelerator",
        "_accelerator_default": "maximize_auto's backend test",
    },
    "core/pmat.py": {
        "_PREC": "TPU matmul precision (bf16 passes); the port's float32 "
        "products run in full float32 (`_mm`)",
        "_POWS_SEQ": "PAML_TPU_POWS, a TPU tuning knob; the port keeps the "
        "sequential chain",
        "_eigh_refined": "a hook that only calls eigh",
    },
    "core/pruning.py": {
        "_PRECISION": "TPU matmul precision of the einsum paths",
        "set_matmul_precision": "sets _PRECISION",
        "_MAX_UNROLL": "the XLA unroll limit of the level path",
        "_WIDE_NNODE": "the switch to the wide path",
        "_class_site_lnf_wide": "the wide einsum path (XLA on the TPU)",
        "_forward_levels_wide": "the wide path's forward",
        "_lnf_wide_fwd": "the wide path's VJP",
        "_lnf_wide_bwd": "the wide path's VJP",
        "_wide_sched": "the wide path's schedule",
        "_class_site_lnf_scan": "the lax.scan path past _MAX_UNROLL levels",
        "_forward_buffers": "the scan path's forward",
        "_lnf_scan_fwd": "the scan path's VJP",
        "_lnf_scan_bwd": "the scan path's VJP",
        "_schedule": "the scan path's schedule",
    },
}

# module -> names that nothing in paml_tpu, its entry points or its tests
# uses (checked below): dead code, not copied
NO_CALLER = {
    "apps/beb.py": {"_mle_qfactor"},   # `neb` computes wbar inline
}

# module -> {JAX name: the port's counterpart}
RENAMED = {
    "core/optim.py": {"maximize_jax": "maximize_device",
                      "maximize_jax_bounded": "maximize_device_bounded"},
    "core/dgamma.py": {"_betaincinv_jvp": "_BetaIncInv"},
    "core/pmat.py": {"_pmat_rev_spectral": "_PmatRevSpectral",
                     "_pmat_rev_jvp": "_PmatRevSpectral"},
    "core/pruning.py": {"_class_site_lnf_lvl": "_ClassSiteLnfLvl",
                        "_lnf_lvl_fwd": "_ClassSiteLnfLvl"},
    "utils/timing.py": {"xla_trace": "torch_trace"},
}


def top_level_names(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                names.update(n.id for n in ast.walk(target)
                             if isinstance(n, ast.Name))
    return names


MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_every_name_has_a_counterpart(module):
    port = PORT / module
    if module in NOT_PORTED_MODULES:
        assert not port.exists(), f"{module} is ported: drop its exception"
        return
    assert port.exists(), f"paml_tpu_torch/{module} is missing"
    want = top_level_names(JAX_PKG / module)
    have = top_level_names(port)
    skip = {**NOT_PORTED.get(module, {}),
            **dict.fromkeys(NO_CALLER.get(module, ()), "no caller")}
    renamed = RENAMED.get(module, {})
    for name in list(skip) + list(renamed):
        assert name in want, f"{module}: {name} is gone from paml_tpu"
        assert name not in have, f"{module}: {name} is ported now"
    for name, target in renamed.items():
        assert target in have, f"{module}: {target} ({name}) is missing"
    missing = sorted(want - have - set(skip) - set(renamed))
    assert not missing, f"{module}: {missing} not in paml_tpu_torch"


def test_exceptions_name_real_modules():
    for module in (list(NOT_PORTED) + list(RENAMED) + list(NOT_PORTED_MODULES)
                   + list(NO_CALLER)):
        assert module in MODULES, module


@pytest.mark.parametrize("module,name", sorted(
    (m, n) for m, names in NO_CALLER.items() for n in names))
def test_no_caller_names_are_dead(module, name):
    """A NO_CALLER name appears once in the JAX package, its tests and its
    entry points: where it is defined."""
    files = (list(JAX_PKG.rglob("*.py"))
             + [p for p in (ROOT / "tests").glob("test_*.py")
                if not p.name.startswith("test_torch_")]
             + [ROOT / f for f in ("bench.py", "bench_examples.py",
                                   "__graft_entry__.py")])
    uses = sum(sum(1 for n in ast.walk(ast.parse(p.read_text()))
                   if (isinstance(n, ast.Name) and n.id == name)
                   or (isinstance(n, ast.Attribute) and n.attr == name)
                   or (isinstance(n, ast.FunctionDef) and n.name == name))
               for p in files if p.exists())
    assert uses == 1, f"{module}: {name} is used {uses - 1} times"
