"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the measured program. Module names are
compared by their whole top-level name: the program's own name,
macarons_tpu_torch, begins with the JAX package's."""

import ast
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

from benchmark.harness import core  # noqa: E402
PROGRAM = "macarons_tpu_torch"


def top_level_imports(path):
    """The whole top-level names that a Python file imports, at any depth
    of its code (function bodies included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def python_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_in_the_harness_sources():
    for path in python_files(BENCH):
        if os.sep + "tests" + os.sep in path:
            continue
        bad = top_level_imports(path) & set(core.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in python_files(os.path.join(BENCH, "reference")):
        names = top_level_imports(path)
        assert PROGRAM not in names, f"{path} imports the program"
        assert not names & set(core.FORBIDDEN), path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "macarons_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert "macarons_tpu" not in core.forbidden_modules()
    assert "jax" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in core.forbidden_modules()


def test_a_run_loads_no_jax():
    """Import every module the harness and the program's entry points load,
    in a fresh process, and look at sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.harness.core as core\n"
        "import benchmark.drivers.explore, benchmark.drivers.pretrain_vis\n"
        "import benchmark.reference.explore, benchmark.reference.pretrain_vis\n"
        "import macarons_tpu_torch.testers.scene\n"
        "import macarons_tpu_torch.trainers.pretrain_vis\n"
        "import macarons_tpu_torch.data.generate_shapenet_data\n"
        "import json; print(json.dumps(core.forbidden_modules()))\n"
        % os.path.dirname(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=dict(os.environ,
                                                         USE_FLAX="0"))
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_alone_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.explore, "
            "benchmark.reference.pretrain_vis\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'macarons_tpu_torch'))\n"
            % os.path.dirname(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_run_exits_without_a_card_and_prints_nothing():
    """Without CUDA the run exits with a code other than 0 and no result
    line (on the card this test has nothing to show)."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "explore.macarons-default", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
