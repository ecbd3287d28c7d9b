"""The port's copies of the framework-free modules stay equal to the
reference's, and the port imports neither JAX nor the JAX package.

``repro_torch`` keeps its own copies of ``core/isa``, ``programs``,
``floatprog``, ``ref`` and ``configs``.  These tests hold each copy to
its original byte for byte and on the programs the slice runs
(fingerprint, cycles, footprint, expanded stream).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import floatprog as ref_floatprog  # noqa: E402
from repro.core import programs as ref_programs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import floatprog, programs  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
_COPIED = ["core/isa.py", "core/programs.py", "core/floatprog.py",
           "core/ref.py"] + sorted(
    f"configs/{p.name}" for p in (SRC / "repro" / "configs").glob("*.py")
    if p.name != "__init__.py")


@pytest.mark.parametrize("rel", _COPIED)
def test_copied_module_is_byte_identical(rel):
    assert (SRC / "repro_torch" / rel).read_bytes() \
        == (SRC / "repro" / rel).read_bytes(), rel


_PROGRAMS = {
    "iadd8": lambda p: p.iadd(8, rows=512),
    "imul4": lambda p: p.imul(4, rows=512),
    "imul8": lambda p: p.imul(8, rows=512),
    "idot4": lambda p: p.idot(4, rows=512),
    "idot8": lambda p: p.idot(8, rows=512),
    "idot4x26": lambda p: p.idot(4, rows=512, tuples=26),
}


def _bf16_dot(fp):
    return fp.float_dot(fp.BF16, rows=512, tuples=2)


@pytest.mark.parametrize("name", sorted(_PROGRAMS) + ["bf16_dot"])
def test_copied_programs_expand_identically(name):
    if name == "bf16_dot":
        (p, lay), (q, qlay) = _bf16_dot(floatprog), _bf16_dot(ref_floatprog)
    else:
        (p, lay), (q, qlay) = (_PROGRAMS[name](programs),
                               _PROGRAMS[name](ref_programs))
    assert p.fingerprint() == q.fingerprint()
    assert (p.cycles(), p.footprint()) == (q.cycles(), q.footprint())
    assert [tuple(dataclasses.astuple(i)) for i in p.expand()] \
        == [tuple(dataclasses.astuple(i)) for i in q.expand()]
    assert (lay.rows, lay.stride, lay.tuples, lay.fields) \
        == (qlay.rows, qlay.stride, qlay.tuples, qlay.fields)


def test_copied_config_registry_matches():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config("qwen2-0.5b", smoke)) \
            == dataclasses.asdict(ref_get_config("qwen2-0.5b", smoke))


_NO_REFERENCE = (
    "bad = sorted(k for k in sys.modules if k == 'jax' or "
    "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
    "assert not bad, bad\n"
    "print(len([k for k in sys.modules if k.startswith('repro_torch')]))"
)


def _run_isolated(code):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=SRC.parent, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return int(out.stdout.strip())


def test_port_imports_no_jax_and_no_reference():
    """Importing every module of repro_torch loads neither jax nor any
    module of the reference package."""
    n = _run_isolated(
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n" + _NO_REFERENCE)
    assert n >= 15


def test_chip_smoke_imports_no_jax_and_no_reference():
    """chip_smoke.py (imported, not run) loads the port only."""
    n = _run_isolated("import sys\nsys.path.insert(0, '.')\n"
                      "import chip_smoke\n" + _NO_REFERENCE)
    assert n >= 10
