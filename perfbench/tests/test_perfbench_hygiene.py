"""Nothing the benchmark runs imports JAX or the JAX package ``repro``,
and its reference imports none of JAX, ``repro`` or the port
``repro_torch``. Module names are compared by their top-level name taken
whole: ``repro_torch`` begins with ``repro`` and is not it."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import bench

PKG = Path(bench.__file__).resolve().parent
ROOT = PKG.parent
FILES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)
REF = sorted((PKG / "reference").rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_benchmark_imports_neither_jax_nor_the_jax_package(path):
    bad = [n for n in _imports(path)
           if _top(n) in ("jax", "jaxlib", "flax", "repro")]
    assert bad == [], f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", REF, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    bad = [n for n in _imports(path)
           if _top(n) in ("jax", "jaxlib", "flax", "repro", "repro_torch",
                          "perfbench")]
    assert bad == [], f"{path.name} imports {bad}"


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "repro_torch_like" not in bench.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert bench.banned_modules() == [m for m in bench.banned_modules()
                                      if m.split(".")[0] in bench.BANNED]
    assert "repro.fake" in bench.banned_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Importing the harness and every port module a run uses leaves no
    JAX module behind (a fresh process, with JAX installed here)."""
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from perfbench import bench, check, run, calibrate, sweep\n"
            "from perfbench.reference import model\n"
            "import repro_torch.serve.gateway, repro_torch.routers\n"
            "import repro_torch.fed.harvest\n"
            "print(bench.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_harness_refuses_to_run_without_the_port(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PKG, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    for code in (
            # the command itself (here it also finds no card)
            None,
            # the rest of a run, past the look for a card, on the CPU
            "from perfbench import run as R\n"
            "R.run_cell(R.load('dense-chat'), 1, 1.0, False, 'cpu')"):
        argv = ([sys.executable, "-m", "perfbench.run", "--workload",
                 "dense-chat", "--seed", "1", "--seconds", "1", "--trace",
                 "0"] if code is None else [sys.executable, "-c", code])
        out = subprocess.run(argv, cwd=tmp_path, capture_output=True,
                             text=True, timeout=120, env=env)
        assert out.returncode != 0
        assert "correct" not in out.stdout
    assert "repro_torch" in out.stderr
