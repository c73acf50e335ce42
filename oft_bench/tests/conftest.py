"""Small CPU versions of the benchmark's configurations and mixes: the
configuration files with the processing size cut to 96^2 (fast) or 48^2
(faithful), frames of 96x160, a low gesture threshold so that votes are
cast, and the fast preset's kernel route named (on a CPU tensor each kernel
wrapper runs its plain version, the composition the card's kernels
follow)."""

import copy

import pytest
import torch

from oft_bench import spec

# one thread a test process: the workers of a parallel run share the cores
torch.set_num_threads(1)

FRAME_HW = (96, 160)


def small_config(name: str) -> dict:
    cfg = copy.deepcopy(spec.config(name))
    size = 96 if name.startswith("fast") else 48
    cfg["frame_hw"] = list(FRAME_HW)
    cfg["video"]["preprocess"]["size"] = [size, size]
    cfg["video"]["gesture"]["mag_thresh"] = 2.0
    if cfg["video"]["flow"]["mode"] == "corrected":
        cfg["video"]["flow"].update(impl="cuda", pyr_impl="cuda", warp_impl="shift_sep")
    cfg["check"]["limits"]["compared"] = 1
    return cfg


def small_mix(name: str) -> dict:
    mix = dict(spec.traffic(name))
    if mix["loop"] == "chunked":
        mix.update(segment_frames=20, chunk_size=5)
    else:
        mix.update(segment_frames=12)
    return mix


@pytest.fixture
def small():
    """(config, mix) of a cell at the CPU tests' size."""

    def make(cell_name):
        cell = spec.cell(spec.load_benchmark(), cell_name)
        return small_config(cell["config"]), small_mix(cell["traffic"])

    return make
