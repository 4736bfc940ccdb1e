"""Nothing the benchmark runs imports JAX, the JAX package, ``bench.py`` or
``chip_smoke.py``. Module names are compared by their whole top-level name:
``mdgat_tpu_torch`` (the port) is not ``mdgat_tpu`` (the JAX package)."""

import ast
import json
import subprocess
import sys
import types

from bench_gpu.harness import common

SOURCES = sorted(p for p in common.PKG.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_a_forbidden_module():
    assert SOURCES
    for path in SOURCES:
        bad = set(top_level_imports(path)) & set(common.FORBIDDEN)
        assert not bad, (path, bad)


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "mdgat_tpu_torch_probe",
                        types.ModuleType("mdgat_tpu_torch_probe"))
    assert "mdgat_tpu_torch_probe" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mdgat_tpu.probe",
                        types.ModuleType("mdgat_tpu.probe"))
    assert common.forbidden_modules() == ["mdgat_tpu.probe"]


def test_a_run_process_loads_none():
    """Every module a run imports, the program's and each configuration's
    architecture included, in a fresh process: none of them pulls in a
    forbidden one."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import bench_gpu.run, bench_gpu.calibrate\n"
        "import bench_gpu.harness.cells\n"
        "from bench_gpu.harness import common\n"
        "for m in common.benchmark()['per_layer']:\n"
        "    common.metric_reader(m['name'])\n"
        "for c in common.benchmark()['configs']:\n"
        "    common.architecture(common.config(c['name']))\n"
        "import json; print(json.dumps(common.forbidden_modules()))\n"
        % str(common.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(common.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
