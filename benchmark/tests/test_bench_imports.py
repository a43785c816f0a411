"""What the benchmark imports: nothing of JAX or of the JAX package
``snarkos_tpu`` anywhere (top-level names compared whole: the port,
``snarkos_tpu_torch``, begins with the JAX package's name), and in the plain
reference nothing of the program either."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "snarkos_tpu"}


def _sources():
    for d, _, files in os.walk(HERE):
        if "__pycache__" in d:
            continue
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_top_level_names_compare_whole():
    assert "snarkos_tpu_torch.ops.msm".split(".")[0] not in FORBIDDEN
    assert "snarkos_tpu.ops.msm".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", [p for p in _sources()
                                  if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"benchmark", "numpy", "hashlib", "functools", "json", "sys", "__future__"}
    mods = set(_imports(path))
    assert all(m.split(".")[0] in allowed for m in mods), mods
    assert all(m.startswith("benchmark.reference") for m in mods
               if m.split(".")[0] == "benchmark"), mods


def test_the_harness_loads_no_jax():
    """Import the harness, every driver, layer and metric file and the
    program's entries they reach, in a fresh process, and look at
    sys.modules."""
    code = """
import sys
sys.path.insert(0, {root!r})
from benchmark import harness, run, trace, loadgen
b = harness.Benchmark()
for d in ("drivers", "metrics"):
    import os
    for f in os.listdir(os.path.join(harness.HERE, d)):
        if f.endswith(".py"):
            harness.load_file(d, f[:-3])
for layer in b.layers().values():
    for t in layer.TARGETS:
        trace.resolve(t)
print(harness.forbidden_modules())
""".format(root=ROOT)
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_caches_lie_inside_the_checkout(tmp_path):
    """After ``run.prepare()`` the toolchains' caches and the bytecode cache
    are fixed paths under the checkout's ``build/cache``, and a module
    imported then leaves its bytecode there, even where the environment
    says not to write bytecode."""
    mod = tmp_path / "bench_probe_mod.py"
    mod.write_text("X = 1\n")
    code = """
import os, sys
sys.path.insert(0, {root!r})
from benchmark import run
run.prepare()
sys.path.insert(0, {tmp!r})
import bench_probe_mod
print(sys.pycache_prefix)
print(*(os.environ[v] for v in run.CACHES))
""".format(root=ROOT, tmp=str(tmp_path))
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    prefix, caches = out.stdout.strip().splitlines()[-2:]
    cache_root = os.path.join(ROOT, "build", "cache")
    assert prefix == os.path.join(cache_root, "pycache")
    assert all(c.startswith(cache_root + os.sep) for c in caches.split())
    tag = sys.implementation.cache_tag
    written = os.path.join(prefix + str(tmp_path), f"bench_probe_mod.{tag}.pyc")
    assert os.path.isfile(written)
    assert not (tmp_path / "__pycache__").exists()
