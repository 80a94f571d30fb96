"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and for
the reference nothing of the program either."""

import ast
import subprocess
import sys

import pytest

from pokerbench import run

FORBIDDEN = ("jax", "jaxlib", "flax", "mental_poker_tpu")
REFERENCE = run.ROOT / "pokerbench" / "reference"


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = _loaded("import pokerbench.run, pokerbench.trace, pokerbench.window, pokerbench.faults\n"
                  "import pokerbench.drivers.shuffle, pokerbench.drivers.multigame\n"
                  "import json\n"
                  "for m in json.load(open('BENCHMARK.json'))['end_to_end'] + json.load(open('BENCHMARK.json'))['per_layer']:\n"
                  "    pokerbench.run.reader(m['name'])")
    assert "mental_poker_tpu_torch" in top  # the drivers load the program ...
    assert not top & set(FORBIDDEN)  # ... and nothing of JAX


def test_reference_loads_nothing_of_the_program():
    top = _loaded("import pokerbench.reference.shuffle, pokerbench.reference.game, pokerbench.inputs")
    assert not top & (set(FORBIDDEN) | {"mental_poker_tpu_torch", "torch"})


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_no_program(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & (set(FORBIDDEN) | {"mental_poker_tpu_torch", "torch"}), names


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mental_poker_tpu_torch_x", sys)
    assert run.forbidden_modules() == [m for m in run.forbidden_modules() if m in FORBIDDEN]
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()
