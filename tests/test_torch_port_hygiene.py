"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, nor a package the card's machine lacks (pandas, yaml, wandb,
orbax), and no port source (nor chip_smoke.py, chip_profile.py, the port's
bench script or the data-parallel tests' worker process) has such an
import."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tss_dprnn_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "tss_dprnn_tpu", "orbax", "pandas", "yaml", "wandb")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_profile.py",
                                         ROOT / "scripts" / "port" / "bench_serve.py",
                                         ROOT / "tests" / "torch_port_ddp_worker.py"]


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tss_dprnn_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'tss_dprnn_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke, chip_profile\n"
        "sys.path.insert(0, 'tests'); import torch_port_ddp_worker\n"
        f"roots = {FORBIDDEN_ROOTS!r}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_statements(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in FORBIDDEN_ROOTS, f"{path}:{node.lineno} imports {mod}"


def test_chip_smoke_stops_what_its_children_leave_behind():
    # a child in a session of its own (as torch.distributed.run starts its
    # launcher) leaves two processes behind, one of which ignores SIGTERM
    code = (
        "import os, subprocess, sys, time\n"
        "import chip_smoke as cs\n"
        "cs.become_subreaper()\n"
        "subprocess.run([sys.executable, '-c', \"import subprocess; "
        "subprocess.Popen(['sleep', '300'], start_new_session=True); "
        "subprocess.Popen(['sh', '-c', 'trap \\\"\\\" TERM; sleep 300'])\"], "
        "start_new_session=True, check=True)\n"
        "time.sleep(0.5)\n"
        "stopped = cs.stop_descendants(grace_s=1.0)\n"
        "print(stopped, cs._descendants())\n"
        "sys.exit(0 if len(stopped) == 3 and not cs._descendants() else 1)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=60, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
