"""The port imports neither JAX nor the JAX package: every module under
`mental_poker_tpu_torch/` and `chip_smoke.py`, checked on their syntax
trees (so a lazy import inside a function is caught too)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "mental_poker_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mental_poker_tpu")


def _imported(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_files_found():
    names = {p.name for p in FILES}
    assert {"staged.py", "msm.py", "field.py", "dl_cards.py", "round.py", "chip_smoke.py",
            "config.py", "parameter_selection.py", "sigma_device.py", "bench.py",
            "sharding.py", "distributed.py", "dryrun.py", "scaling.py", "profiling.py"} <= names
