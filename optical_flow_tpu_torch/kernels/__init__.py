"""Hand-written CUDA kernels for the H100 (sm_90a), one per TPU kernel of
the repository and W1 and F1 for chains the JAX package left to XLA, each
with its plain PyTorch version:

  K1  lk_kernel.lucas_kanade_cuda         csrc/lk.cu (a warp a strip of rows, the
      whole LK tail in registers; strip shape by the grid)
  K2  pyrdown_kernel.pyr_down_cuda        csrc/pyrdown.cu (one level), and
      pyrdown_kernel.gaussian_pyramid_cuda (every level below the input,
      one call of the same kernel)
  K3  warp_lk_kernel.pyrup_warp_lk_cuda   csrc/warp_lk.cu
  K4  warp_lk_kernel.warp_lk_cuda         csrc/warp_lk.cu
  K5  the tile mode of K3/K4 (halo=, origin=, global_hw=; entry points
      oft_pyrup_warp_lk_tile, oft_warp_lk_tile), csrc/warp_lk.cu
  P1  tile_copy_kernel.tile_copy_cuda     csrc/tile_copy.cu (the mesh probe)
  S1  pyrup_kernel.pyr_up_pair_cuda       csrc/pyrup.cu (reference mode's upsample:
      a thread two coarse columns down a strip, 16-byte stores at even widths)
  W1  remap_kernel.symmetric_remap_cuda   csrc/remap.cu (reference mode's 'gather' warp of
      both frames; replaces no TPU kernel: the JAX warp is an XLA gather)
  F1  features_kernel.diff_features_cuda  csrc/features.cu (the frame's feature map,
      diff_features, in one launch; replaces no TPU kernel: XLA fuses the JAX chain)
  S2  probes.interleave_{rows,cols}_cuda  csrc/probes.cu (probes: no flow path
  S3  probes.colsum_cuda                  csrc/probes.cu  calls them)
  S4  probes.mul_add_chain_cuda           csrc/probes.cu

A wrapper given a CUDA tensor launches its kernel or raises; given a CPU
tensor it runs the plain version. Launches are counted in
``_lib.launches`` (``launch_counts()``, ``reset_launch_counts()``).
"""

from typing import Dict

from optical_flow_tpu_torch.kernels import _lib
from optical_flow_tpu_torch.kernels.features_kernel import diff_features_cuda
from optical_flow_tpu_torch.kernels.lk_kernel import lucas_kanade_cuda
from optical_flow_tpu_torch.kernels.pyrdown_kernel import gaussian_pyramid_cuda, pyr_down_cuda
from optical_flow_tpu_torch.kernels.pyrup_kernel import pyr_up_pair_cuda
from optical_flow_tpu_torch.kernels.remap_kernel import symmetric_remap_cuda
from optical_flow_tpu_torch.kernels.tile_copy_kernel import tile_copy_cuda
from optical_flow_tpu_torch.kernels.warp_lk_kernel import pyrup_warp_lk_cuda, warp_lk_cuda


def launch_counts() -> Dict[str, int]:
    """Launches so far, by C entry point."""
    return dict(_lib.launches)


def reset_launch_counts() -> None:
    _lib.reset_launches()


__all__ = [
    "diff_features_cuda",
    "gaussian_pyramid_cuda",
    "launch_counts",
    "lucas_kanade_cuda",
    "pyr_down_cuda",
    "pyr_up_pair_cuda",
    "pyrup_warp_lk_cuda",
    "reset_launch_counts",
    "symmetric_remap_cuda",
    "tile_copy_cuda",
    "warp_lk_cuda",
]
