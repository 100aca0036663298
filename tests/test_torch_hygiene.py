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
    assert {"fused_lanczos.cu", "transform.cu", "chip_smoke.py", "lanczos.py"} <= names


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
