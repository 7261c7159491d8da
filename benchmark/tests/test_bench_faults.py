"""A run with its timed path broken underneath comes out not correct.

Each test drives a whole run on the CPU at a small size (the harness's
look for a card skipped, the program's plain versions), with the
program's `Pipeline.process` broken in one of the ways a change could
break it, and checks that `correct` reads false under the cells' own
limits:
  unchanged       the stages return the input frames, nothing inpainted
                  (a step that returns its state unchanged);
  half_left_out   the second half of the clip's frames come back as
                  they went in (half of the batch left out);
  answer_altered  the clip's composed bytes moved by 4 levels where the
                  pipeline produces them.
A sound run on the same path is correct (test_bench_harness.py).
"""

import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.core import session  # noqa: E402

torch.set_num_threads(4)


def small(spec):
    spec.config = dict(spec.config, widgets=dict(spec.config["widgets"], width=160, height=128, raft_iter=2,
                                                 neighbor_length=4, ref_stride=2, fp16="disable"))
    spec.mix = dict(spec.mix, frames=6, margin_px=4)


def _broken(real, fault):
    def process(self, frames_norm, flow_masks, masks_dilated, original_frames, crop=None):
        out = real(self, frames_norm, flow_masks, masks_dilated, original_frames, crop)
        orig = original_frames
        if crop is not None:
            y0, x0, ch, cw = crop
            orig = original_frames[:, y0 : y0 + ch, x0 : x0 + cw]
        if fault == "unchanged":
            return orig.clone()
        if fault == "half_left_out":
            out = out.clone()
            half = out.shape[0] // 2
            out[half:] = orig[half:]
            return out
        return torch.clamp(out + 4.0, 0.0, 255.0)

    return process


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("workload", ["inpaint-360p-fp32.object", "outpaint-360p.sides"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    from comfyui_propainter_nodes_tpu_torch.pipeline import stages

    monkeypatch.setattr(stages.Pipeline, "process", _broken(stages.Pipeline.process, fault))
    args = types.SimpleNamespace(workload=workload, seed=2**31 + 99, seconds=0.1, trace=0)
    result, checks = session.run(args, device="cpu", adjust=small)
    assert result["failed"] == 0  # well formed: only the comparison can see the fault
    assert not result["correct"], checks
    assert any(c["value"] > c["limit"] for name, c in checks.items() if name not in ("masks_mismatch", "outside_max"))
