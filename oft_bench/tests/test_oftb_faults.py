"""A run with the timed path broken underneath comes out not correct: the
whole run but the look for a chip, at the CPU tests' size, once for each
fault a cell can have (one chip, so no exchange between chips to leave
out):

- a step that returns its state unchanged (every cell);
- half of a chunk's frames left out, their flow the mean of the rest's
  (the chunked cell, the only one with a batch);
- an answer altered where it is produced: the flow of each result moved by
  a pixel over a 16x16 block, or along the frame's bottom row (every cell).

A sound run of the same cells and seeds comes out correct."""

import pytest
import torch

from oft_bench import harness, spec
from optical_flow_tpu_torch.pipeline.video import VideoPipeline

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(VideoPipeline, "_carry", lambda self, state: None)


def _half_batch(monkeypatch):
    real = VideoPipeline._flow_from_pyr_pairs

    def half(self, prev_pyr, pyr):
        n = pyr[0].shape[0] if pyr[0].ndim == 3 else 1
        if n < 2:
            return real(self, prev_pyr, pyr)
        k = n // 2
        r = real(self, tuple(p[:k] for p in prev_pyr), tuple(p[:k] for p in pyr))
        u = torch.cat([r.u, r.u.mean(0, keepdim=True).expand(n - k, -1, -1)])
        v = torch.cat([r.v, r.v.mean(0, keepdim=True).expand(n - k, -1, -1)])
        return self._result(u, v)

    monkeypatch.setattr(VideoPipeline, "_flow_from_pyr_pairs", half)


def _answer_altered(monkeypatch):
    real = VideoPipeline._result

    def altered(self, u, v):
        u = u.clone()
        u[..., 8:24, 8:24] += 1.0
        return real(self, u, v)

    monkeypatch.setattr(VideoPipeline, "_result", altered)


def _bottom_row_altered(monkeypatch):
    real = VideoPipeline._result

    def altered(self, u, v):
        u = u.clone()
        u[..., -1, :] += 1.0
        return real(self, u, v)

    monkeypatch.setattr(VideoPipeline, "_result", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "bottom_row_altered": _bottom_row_altered}


def _cases():
    for cell in CELLS:
        loop = spec.traffic(spec.cell(spec.load_benchmark(), cell)["traffic"])["loop"]
        for fault in FAULTS:
            if fault == "half_batch" and loop != "chunked":
                continue
            yield cell, fault


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_a_broken_timed_path_is_not_correct(cell, fault, small, monkeypatch):
    cfg, mix = small(cell)
    FAULTS[fault](monkeypatch)
    out = harness.run_cell(cell, 2 ** 31 + 99, 2.0, False, "cpu", cfg=cfg, mix=mix)
    assert out["line"]["attempted"] > 0
    assert out["line"]["correct"] is False, out["line"]["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct_on_the_same_seed(cell, small):
    cfg, mix = small(cell)
    out = harness.run_cell(cell, 2 ** 31 + 99, 2.0, False, "cpu", cfg=cfg, mix=mix)
    assert out["line"]["correct"] is True, out["line"]["check"]
