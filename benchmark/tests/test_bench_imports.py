"""What the benchmark imports, by whole top-level module names: nothing
of JAX or of the JAX package anywhere under benchmark/, and nothing of
the program in the reference."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

import tiny
from harness import FORBIDDEN

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(tiny.ROOT) for f in fs
               if f.endswith(".py"))


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, tiny.ROOT))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if "/reference/" in p],
                         ids=lambda p: os.path.relpath(p, tiny.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "insv2v_torch" not in names and not names & set(FORBIDDEN)
    assert names <= {"__future__", "contextlib", "difflib", "html", "json", "math", "os",
                     "typing", "numpy", "torch", "cv2"}


def test_a_run_loads_no_jax():
    """The harness, the drivers and the references, imported together with
    the program, load no module whose top-level name is forbidden."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import harness, run, reference.insv2v, reference.modelscope, calibrate\n"
            "from harness import Cell, forbidden_modules\n"
            "for n in ('insv2v.edit-32f-256x384-ddim50', 'modelscope.ptp-v2-16f-256-ddim30'):\n"
            "    Cell.load(n).driver()\n"
            "import insv2v_torch.diffusion.pipeline, insv2v_torch.diffusion.ptp_sampler\n"
            "import insv2v_torch.utils.clip_metrics, insv2v_torch.apps.generate_dataset\n"
            "print(forbidden_modules())" % (tiny.ROOT, tiny.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
