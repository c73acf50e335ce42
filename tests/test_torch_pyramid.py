"""The one-launch pyramid of kernel K2 (``gaussian_pyramid_cuda``) against the
JAX package's ``gaussian_pyramid`` ('poly'), level by level, at K2's
tolerance (atol 2e-3, tests/test_kernels.py:100-101); its levels' layout in
one buffer; the routes of ``ops/pyramid.gaussian_pyramid``; its cost model.
On the CPU the wrapper fills the kernel's buffer with its plain version.

The tests marked ``cuda`` hold the kernel against the plain pyramid bit for
bit on a card and count its launches; they skip where there is none.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from optical_flow_tpu.ops.pyramid import gaussian_pyramid as j_gaussian_pyramid
from optical_flow_tpu_torch.kernels import launch_counts
from optical_flow_tpu_torch.kernels.pyrdown_kernel import gaussian_pyramid_cuda, level_layout
from optical_flow_tpu_torch.ops.pyramid import gaussian_pyramid, max_pyramid_levels
from optical_flow_tpu_torch.utils import profiling

ATOL_K2 = 2e-3

# (shape, levels); None: max_pyramid_levels, as the controllers take it
_CASES = {
    "2x256x256-4": ((2, 256, 256), 4),
    "135x271-max": ((135, 271), None),  # both sides odd: one level
    "135x271-to-1x1": ((135, 271), 10),
    "64x64-max-to-1x1": ((64, 64), None),  # 7 levels, down to 1x1
    "3x7-3": ((3, 7), 3),  # planes under 3 px: the general reflect
}


def _levels(shape, levels):
    return max_pyramid_levels(shape) if levels is None else levels


@pytest.mark.parametrize("case", list(_CASES))
def test_gaussian_pyramid_cuda_matches_jax(case):
    shape, levels = _CASES[case]
    levels = _levels(shape, levels)
    x = (np.random.RandomState(11).rand(*shape) * 255).astype(np.float32)
    got = gaussian_pyramid_cuda(torch.from_numpy(x), levels)  # CPU tensor: the plain version
    want = j_gaussian_pyramid(jnp.asarray(x), levels)
    assert len(got) == len(want) == levels
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_K2, rtol=0)
    if case.endswith("to-1x1"):
        assert tuple(got[-1].shape[-2:]) == (1, 1)


@pytest.mark.parametrize("shape,levels", [((2, 37, 51), 4), ((1, 3, 8, 8), 4), ((5, 3), 3)])
def test_pyramid_levels_are_views_of_one_buffer(shape, levels):
    x = torch.rand(*shape)
    pyr = gaussian_pyramid_cuda(x, levels)
    assert pyr[0] is x
    B = x.numel() // (shape[-2] * shape[-1])
    layout, total = level_layout(B, shape[-2], shape[-1], levels)
    base = pyr[1].untyped_storage().data_ptr()
    assert pyr[1].untyped_storage().nbytes() == 4 * total
    h, w = shape[-2:]
    for level, (off, ho, wo) in zip(pyr[1:], layout):
        h, w = -(-h // 2), -(-w // 2)
        assert (ho, wo) == (h, w) and tuple(level.shape) == tuple(shape[:-2]) + (h, w)
        assert level.untyped_storage().data_ptr() == base
        assert level.storage_offset() == off and off % 4 == 0
        assert level.is_contiguous() and level.dtype == torch.float32


@pytest.mark.parametrize("impl", ["cuda", "auto"])
def test_gaussian_pyramid_routes_agree_with_poly(impl):
    x = torch.from_numpy((np.random.RandomState(12).rand(2, 40, 72) * 255).astype(np.float32))
    before = launch_counts()
    for a, b in zip(gaussian_pyramid(x, 4, impl=impl), gaussian_pyramid(x, 4, impl="poly")):
        assert torch.equal(a, b)
    u8 = torch.from_numpy(np.random.RandomState(13).randint(0, 256, (24, 40), dtype=np.uint8))
    got, want = gaussian_pyramid(u8, 3, impl=impl), gaussian_pyramid(u8, 3, impl="poly")
    assert got[0] is u8 and got[1].dtype == torch.float32
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    assert launch_counts() == before  # CPU tensors launch nothing
    with pytest.raises(ValueError):
        gaussian_pyramid(x, 3, impl="mxu")


def test_pyramid_cost_counts_every_level_once():
    """The input read once, each level below it written once (not read back:
    the function does not need it), 27 operations an output."""
    pyr = gaussian_pyramid_cuda(torch.zeros(1080, 1080), 4)
    written = 540 * 540 + 270 * 270 + 135 * 135
    cost = profiling.kernel_cost("pyramid", pyr[:1], pyr[1:],
                                 outputs_counted=sum(p.numel() for p in pyr[1:]))
    assert cost.bytes == 4 * (1080 * 1080 + written)
    assert cost.ops == 27 * written
    # 6.20 MB at 3.35 TB/s
    assert abs(profiling.stage_roofline(cost)["bound_ms"] * 1e3 - 1.8497) < 1e-3


# ---------------------------------------------------- on the card (marked)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_pyramid_kernel_on_card(cuda_device):
    """One launch per pyramid, bit for bit with the plain pyramid: the main
    path's shape, a pyramid to 1x1 (11 levels), ragged and tiny planes."""
    rng = np.random.RandomState(14)
    cases = [((2, 1080, 1080), 4), ((1024, 1024), None), ((135, 271), 10), ((3, 7), 3),
             ((1, 1), 3)]
    for shape, levels in cases:
        levels = _levels(shape, levels)
        x = torch.from_numpy((rng.rand(*shape) * 255).astype(np.float32)).to(cuda_device)
        before = launch_counts()
        got = gaussian_pyramid_cuda(x, levels)
        torch.cuda.synchronize()
        after = launch_counts()
        assert after["oft_pyramid"] == before["oft_pyramid"] + 1
        assert after["oft_pyrdown"] == before["oft_pyrdown"]
        want = gaussian_pyramid(x, levels, impl="poly")
        assert len(got) == levels
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.cuda
def test_gaussian_pyramid_auto_is_one_launch_on_card(cuda_device):
    x = torch.rand(2, 270, 270, device=cuda_device)
    before = launch_counts()
    got = gaussian_pyramid(x, 4, impl="auto")
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["oft_pyramid"] - before["oft_pyramid"] == 1
    assert after["oft_pyrdown"] == before["oft_pyrdown"]
    for g, w in zip(got, gaussian_pyramid(x, 4, impl="poly")):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
