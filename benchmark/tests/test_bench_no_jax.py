"""Nothing the harness loads is JAX or the JAX package, compared by whole
top-level module names (the program's name, ``tss_dprnn_tpu_torch``, begins
with the JAX package's), and the reference loads nothing of the program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _loaded(code: str):
    prog = ("import sys\nsys.path.insert(0, %r)\n" % str(ROOT) + code
            + "\nprint(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return set(eval(proc.stdout.strip().splitlines()[-1]))


def test_the_harness_and_every_cells_pieces_load_no_jax():
    roots = _loaded(
        "from benchmark.lib.registry import Registry\n"
        "from benchmark.lib import harness, trace\n"
        "import benchmark.reference.dprnn, benchmark.reference.training\n"
        "reg = Registry()\n"
        "for w in reg.spec['workloads']:\n"
        "    c = reg.config(w['config']); t = reg.traffic(w['traffic']); reg.flops(c['flops'])\n"
        "    reg.family(c['family']); reg.loop(t['loop'])\n"
        "    reg.limits(w['name'])\n"
        "    for kind in ('end_to_end', 'per_layer'):\n"
        "        for m in reg.metrics_of(w['name'], kind): reg.reader(m['name'])\n")
    assert "tss_dprnn_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "tss_dprnn_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    roots = _loaded("import benchmark.reference.dprnn, benchmark.reference.training")
    assert "torch" in roots
    assert not roots & {"tss_dprnn_tpu_torch", "tss_dprnn_tpu", "jax", "jaxlib", "flax"}


def test_the_whole_name_is_compared():
    from benchmark.lib import harness

    sys.modules.setdefault("tss_dprnn_tpu_torch_like", sys)  # a longer name is not the package
    try:
        assert "tss_dprnn_tpu_torch_like" not in harness.forbidden_modules()
    finally:
        del sys.modules["tss_dprnn_tpu_torch_like"]
