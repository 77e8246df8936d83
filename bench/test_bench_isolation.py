"""The benchmark loads neither JAX nor the JAX package (`repro`), and its
reference loads nothing of the program (`repro_torch`): top-level module
names compared whole, in fresh interpreters, and every import statement
under bench/ read from its source."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench.run import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _loaded(code: str) -> list:
    prog = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_the_program_load_no_jax():
    top = _loaded("import bench.run, bench.control\n"
                  "from bench.harness import cell, check, data, program, spec, trace\n"
                  "import repro_torch.federation, repro_torch.models, repro_torch.kernels")
    assert "repro_torch" in top
    assert not set(top) & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("from bench.reference import federation, model, threefry")
    assert "torch" in top
    assert not set(top) & {"repro_torch", *FORBIDDEN}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_source_imports_jax(path):
    names = set(_imports(path))
    assert not names & set(FORBIDDEN)
    if "reference" in path.parts:
        assert "repro_torch" not in names


def test_names_are_compared_whole():
    mods = dict.fromkeys(["repro_torch", "repro_torch.random", "jaxtyping", "reprox", "torch"])
    assert forbidden_modules(mods) == []
    mods.update(dict.fromkeys(["repro", "repro.core", "jax", "jaxlib.xla_client", "flax"]))
    assert forbidden_modules(mods) == ["flax", "jax", "jaxlib.xla_client", "repro",
                                       "repro.core"]
