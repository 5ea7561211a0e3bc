"""Every port test file that holds a ``cuda``-marked test imports without
JAX, flax or the JAX package: the card's machine has none of them, and a
file that fails to import there runs none of its card tests (``pytest
--noconftest -m cuda tests/test_torch_*.py``). Each case imports one such
file in a fresh interpreter whose import system refuses those packages.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
# the files are read, not imported: every worker collects the same cases
CARD_FILES = sorted(
    p.name for p in TESTS.glob("test_torch_*.py")
    if re.search(r"^@pytest\.mark\.cuda\b", p.read_text(), re.M))

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, importlib.util, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "fcsr_tpu"):
            raise ImportError(f"{name} is not installed on the card's machine")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("card_test", sys.argv[2])
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "fcsr_tpu"))
assert not loaded, loaded
print("imported", sys.argv[2])
"""


def test_the_card_files_are_found():
    assert len(CARD_FILES) >= 10
    assert "test_torch_fused_entry_points.py" in CARD_FILES
    assert "test_torch_parallel.py" in CARD_FILES
    assert "test_torch_card_imports.py" not in CARD_FILES


@pytest.mark.parametrize("name", CARD_FILES)
def test_card_file_imports_without_jax(name):
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT), str(TESTS / name)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout


@pytest.mark.parametrize("module", ["fcsr_tpu_torch.parallel",
                                    "fcsr_tpu_torch.parallel.mesh",
                                    "fcsr_tpu_torch.parallel.distributed"])
def test_parallel_modules_import_without_jax(module):
    """The multi-device layer (and what it imports: the trainers, the MLP
    models) loads with JAX, flax and the JAX package refused."""
    code = _BLOCKED_IMPORT.replace(
        'spec = importlib.util.spec_from_file_location("card_test", '
        'sys.argv[2])\nmodule = importlib.util.module_from_spec(spec)\n'
        'spec.loader.exec_module(module)\n',
        "importlib.import_module(sys.argv[2])\n")
    assert "import_module" in code
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), module],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout
