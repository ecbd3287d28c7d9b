"""What the benchmark's files import: never a top-level ``jax`` or
``repro`` (names compared whole: ``repro_torch`` is the port), and in
``reference/`` nothing of the port either."""

import ast
import subprocess
import sys

import pytest

from conftest import BENCH

FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    """Top-level names of every module ``path`` imports (absolute
    imports; a relative import names its own package)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_reference_package(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not imported(path) & {"repro_torch", "pb_harness", "pb_weights",
                                 "pb_traffic"}


def test_a_run_loads_no_jax(tmp_path):
    """A whole smoke-size run in a fresh process, then the loaded
    modules' top-level names (as ``run.py`` checks them once the window
    has closed)."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH / 'tests')!r}]
import pathlib, conftest, run, pb_harness
lay = conftest.tiny_layout(pathlib.Path({str(tmp_path)!r}), [
    ("fabric.qwen2-0.5b-smoke.w4a4", "qwen2-0.5b-smoke", "w4a4"),
    ("serve.qwen2-0.5b-smoke.chat-tiny", "qwen2-0.5b-smoke", "chat-tiny")])
for w in ("fabric.qwen2-0.5b-smoke.w4a4", "serve.qwen2-0.5b-smoke.chat-tiny"):
    assert run.main(["--workload", w, "--seed", "5", "--seconds", "0.2",
                     "--trace", "1"], layout=lay, device="cpu") == 0
print("LOADED", pb_harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"
