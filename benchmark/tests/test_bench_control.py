"""The comparison's control comes out not correct.

The control is the plain reference computed one precision below the
cell's configuration and put in the program's place: float8 e4m3 for a
bf16 configuration (every product's operands and results), TF32 for a
float32 one. Held against the float32 reference under the cell's own
limits, it must fail one of them.

On the card (marked `cuda`; skipped without one) each cell's control
runs at the cell's own size on one seed. On the CPU the float8 control
runs at a small size (TF32 exists only on the card).

    python -m pytest benchmark/tests/test_bench_control.py -q            # CPU
    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q    # on the card
"""

import os
import shutil
import sys
import tempfile

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.core import compare, session, traffic  # noqa: E402


def _control_checks(workload, device, adjust=None, seed=2**31 + 515):
    spec = session.cell_spec(session.manifest(), workload)
    if adjust is not None:
        adjust(spec)
    w = session.widgets(spec)
    kind = spec.mix["node"]
    folder = tempfile.mkdtemp(prefix="bench-control-")
    try:
        session.write_seed_weights(seed, device, folder)
        params = session.reference_params(folder, device)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    image, mask = traffic.inputs(spec.mix, w, seed, 0)
    ref = session.reference(kind, params, image, mask, w, device)
    ctl = session.reference(kind, params, image, mask, w, device, precision=session.CONTROL[spec.config["precision"]])
    return compare.judge([compare.numbers(kind, ctl, ref)], compare.load_limits(spec.limits_path))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in session.manifest()["workloads"]])
def test_the_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size there")
    ok, checks = _control_checks(workload, torch.device("cuda"))
    assert not ok, checks


def test_the_float8_control_fails_at_a_small_size():
    def small(spec):
        spec.config = dict(spec.config, widgets=dict(spec.config["widgets"], width=160, height=128, raft_iter=4,
                                                     neighbor_length=4, ref_stride=2))
        spec.mix = dict(spec.mix, frames=6, margin_px=4)

    torch.set_num_threads(4)
    ok, checks = _control_checks("outpaint-360p.sides", torch.device("cpu"), small)
    assert not ok, checks
