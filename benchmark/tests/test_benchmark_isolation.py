"""Nothing the benchmark runs loads JAX, the JAX package or its native
library, compared by whole top-level module names (the measured
package's name begins with the JAX package's), and the reference loads
nothing of the measured package either."""

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "mpeg_tpu", "native"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_benchmark_source_imports_a_forbidden_module():
    for path in glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                          recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_only_numpy_and_the_standard_library():
    for path in glob.glob(os.path.join(harness.HERE, "reference", "*.py")):
        tops = set(_imports(path))
        assert tops <= {"numpy", "io", "math", "dataclasses", "typing",
                        "functools", "__future__"}, (path, tops)


def test_a_cpu_rehearsal_loads_no_forbidden_module(small):
    code = (
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "harness.setup_environment()\n"
        "res, _ = harness.run_cell('ps1080_av_player', 3, 0.5, True,\n"
        "    device='cpu', folder=%r, cache_dir=%r)\n"
        "assert res['correct'], res\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        % (harness.ROOT, small, harness.CACHE_DIR))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=harness.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "mpeg_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
