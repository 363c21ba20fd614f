"""The benchmark loads neither JAX nor the JAX package, and its reference
and check load nothing of the program under test."""

import ast
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "ood_gan_inversion_tpu"}
PORT = "ood_gan_inversion_tpu_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(PKG)): top_level_imports(p) & JAX_NAMES
             for p in PKG.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}
    # compared whole: the port's name starts with the JAX package's
    assert PORT not in JAX_NAMES and PORT.startswith("ood_gan_inversion_tpu")


def test_reference_and_check_import_nothing_of_the_port():
    files = [*(PKG / "reference").rglob("*.py"), PKG / "weights.py", PKG / "check.py"]
    assert {str(p.relative_to(PKG)) for p in files if PORT in top_level_imports(p)} == set()
    code = ("import sys; sys.path.insert(0, %r); import portbench.check, portbench.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {%r, 'jax', 'flax', "
            "'jaxlib', 'ood_gan_inversion_tpu'}))" % (str(PKG.parent), PORT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
