"""The PyTorch port stands alone: no file of ``krylovkit_tpu_torch/`` nor
``chip_smoke.py`` imports JAX or the JAX package, and importing the port
pulls neither in."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    p for p in (ROOT / "krylovkit_tpu_torch").rglob("*")
    if p.suffix in (".py", ".cu", ".cuh") and "_build" not in p.parts
) + [ROOT / "chip_smoke.py"]

FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+(jax|jaxlib|krylovkit_tpu)(\.|\s|$)", re.M),
    re.compile(r"\bkrylovkit_tpu\."),  # attribute access into the JAX package
    re.compile(r"(__import__|import_module)\(\s*[\'\"](jax|krylovkit_tpu)[\'\".]"),
]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    text = path.read_text()
    bad = [m.group(0) for rx in FORBIDDEN for m in rx.finditer(text)]
    assert not bad, f"{path.name} reaches JAX or the JAX package: {bad}"


def test_port_has_files():
    names = {p.name for p in PORT_FILES}
    assert {
        "fused_lanczos.cu", "transform.cu", "banded_spmv.cu", "laplacian_1d.cu",
        "chip_smoke.py", "lanczos.py", "linsolve.py", "cg.py", "gmres.py", "minres.py",
        "bicgstab.py", "banded.py", "stencil_1d.py", "givens.py", "triangular.py",
        "projections.cu", "projections.py", "arnoldi.py", "schur.py", "realschur.py",
        "expintegrator.py", "gkl.py", "svd.py", "svdsolve.py", "lssolve.py",
        "golubye.py", "blocklanczos.py", "block.py", "sparse.py",
        "gauge.py", "_common.py", "vector.py", "basis.py",
        "biarnoldi.py", "iterators.py", "mesh.py", "operators.py", "batched.py",
        "batched_linsolve.py", "batched_arnoldi.py", "batched_expintegrator.py",
        "batched_gkl.py", "batched_golubye.py", "batched_biarnoldi.py",
    } <= names
    parallel = {p.name for p in PORT_FILES if p.parent.name == "parallel"}
    assert {"__init__.py", "mesh.py", "operators.py", "sparse.py"} <= parallel
    solvers = {p.name for p in PORT_FILES if p.parent.name == "solvers"}
    factorizations = {p.name for p in PORT_FILES if p.parent.name == "factorizations"}
    assert {"biarnoldi.py", "batched.py", "batched_linsolve.py", "batched_arnoldi.py",
            "batched_expintegrator.py", "batched_gkl.py", "batched_golubye.py",
            "batched_biarnoldi.py"} <= solvers
    assert "iterators.py" in factorizations
    ad = {p.name for p in PORT_FILES if p.parent.name == "ad"}
    assert {"__init__.py", "linsolve.py", "eigsolve.py", "svdsolve.py", "gauge.py",
            "_common.py"} <= ad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, krylovkit_tpu_torch, krylovkit_tpu_torch.convert;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'krylovkit_tpu.'))"
        " or m == 'krylovkit_tpu'];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


OPS_FILES = sorted((ROOT / "krylovkit_tpu_torch" / "ops").glob("*.py"))
UPWARD = re.compile(r"^\s*(from\s+(\.\.|krylovkit_tpu_torch\.)parallel|import\s+krylovkit_tpu_torch"
                    r"\.parallel)", re.M)


@pytest.mark.parametrize("path", OPS_FILES, ids=lambda p: p.name)
def test_ops_layer_imports_no_distribution_layer(path):
    """The vector, basis and operator layer sits below ``parallel/``: a
    sharded space holds a ``MeshAxis`` of ``ops/collectives.py``, and a
    sharded operator states its domain through ``TypedOperator``."""
    bad = [m.group(0) for m in UPWARD.finditer(path.read_text())]
    assert not bad, f"{path.name} imports the distribution layer: {bad}"


JAX_ROOT = ROOT / "krylovkit_tpu"
# the Pallas files, whose kernels the port keeps in csrc/ behind its own
# wrapper modules (ops/fused_lanczos.py, banded.py, stencil_1d.py, projections.py)
PALLAS_FILES = ("ops/pallas_fused_lanczos.py", "ops/pallas_spmv.py", "ops/pallas_stencil.py",
                "ops/pallas_basis.py")


def _declared_all(path):
    """The names of ``path``'s ``__all__``, read from its source with
    ``ast`` (nothing of the module is imported), or ``None``."""
    import ast

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return None


# the JAX modules that declare an __all__, by path
JAX_MODULES = sorted(
    p.relative_to(JAX_ROOT).as_posix() for p in JAX_ROOT.rglob("*.py")
    if p.relative_to(JAX_ROOT).as_posix() not in PALLAS_FILES and _declared_all(p) is not None
)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_module_exports_what_the_jax_module_does(rel):
    """Every module of the JAX package (its four Pallas files aside) has a
    port module at the same path whose ``__all__`` holds every name of
    the JAX module's; the JAX side is read from the source, so the port's
    process imports nothing of the JAX package."""
    import importlib

    want = _declared_all(JAX_ROOT / rel)
    name = "krylovkit_tpu_torch." + rel[:-3].replace("/", ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    mod = importlib.import_module(name)
    missing = sorted(set(want) - set(getattr(mod, "__all__", ())))
    assert not missing, f"{name} lacks {missing} of the JAX module's __all__"
    assert all(hasattr(mod, n) for n in want)


def test_dense_is_an_attribute_of_the_package():
    """``kt.dense`` resolves right after ``import krylovkit_tpu_torch`` in a
    fresh interpreter, as the JAX package imports its ``dense`` by name."""
    code = ("import krylovkit_tpu_torch as kt, sys;"
            "sys.exit(0 if kt.dense is sys.modules['krylovkit_tpu_torch.dense']"
            " and 'dense' in kt.__all__ else 1)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
