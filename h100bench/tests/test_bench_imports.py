"""The import rule: nothing a run loads has the top-level name of JAX, its
libraries or the JAX package (compared whole: the port's own name begins
with the JAX package's), and the reference loads nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sln_amodal_tpu"}


def loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", ["sln_r101.eval-b8", "sln_r50.detect-b1", "sln_r101.train-4plus-b8"])
def test_a_run_loads_no_jax(cell):
    top = loaded("import torch; torch.set_num_threads(2)\n"
                 "from h100bench.tests import tiny\n"
                 f"tiny.run({cell!r}, traced=True, cfg={{'backbone': 'resnet50'}})")
    assert "sln_amodal_tpu_torch" in top
    assert not top & FORBIDDEN


def test_readers_and_reference_load_nothing_of_the_program():
    top = loaded("from h100bench import harness\n"
                 "from h100bench.reference import model, host, lowp, trunks\n"
                 "for m in harness.spec()['per_layer']: harness.reader(m['name'])\n"
                 "assert trunks.names()\n"
                 "for t in trunks.names(): trunks.load(t).network({'fpn_channels': 8})")
    assert not top & (FORBIDDEN | {"sln_amodal_tpu_torch"})
