"""Scaling-efficiency report (port of examples/scaling_report.py): frame-
batch amortization on the device, plus the sharded pyramid over a mesh of
the host's cards (or of slots of the one device).

The batch curve (frame pairs per second at batch 1, 2, 4, 8, 16 of the
controller with the JAX script's configuration) is the dominant
production effect on one card. As the JAX script does, the sharded
controller then runs over a mesh of the host's cards where there are two
or more; on one card (or the CPU) it runs over ``MESH_SLOTS`` slots of
that device (``flow_mesh`` with the device repeated, as
``dryrun.py::dryrun_multichip`` does). It uses the fast preset's warp, so
the tile kernels (K5, and P1, the mesh probe) run on a card, and its flow
is held to the unsharded controller's bit for bit.

  python -m optical_flow_tpu_torch.examples.scaling_report [--size 540] [--iters 8] [--device cpu]
"""

import argparse
import dataclasses
import sys
import time

import numpy as np

MESH_SLOTS = 4  # slots of the one device the sharded pyramid runs over


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=540)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from optical_flow_tpu_torch import FlowConfig, coarse_to_fine
    from optical_flow_tpu_torch.config import VideoConfig
    from optical_flow_tpu_torch.ops.pyramid import max_pyramid_levels
    from optical_flow_tpu_torch.utils.device import as_tensor, canonical_device

    device = canonical_device(args.device)
    on_card = device.type == "cuda"
    n_dev = torch.cuda.device_count() if on_card else 1
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    H = W = args.size
    levels = max_pyramid_levels((H, W))
    cfg = FlowConfig(impl="auto", levels=levels)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def run(batch):
        def mk(seed):
            r = np.random.RandomState(seed)
            shape = (batch, H, W) if batch > 1 else (H, W)
            a = r.rand(*shape).astype(np.float32)
            return as_tensor(a, device), as_tensor(np.roll(a, 2, axis=-1), device)

        ps = [mk(s) for s in range(2 + args.iters)]
        for p in ps[:2]:
            coarse_to_fine(*p, levels, config=cfg)
        sync()
        t0 = time.perf_counter()
        for p in ps[2:]:
            coarse_to_fine(*p, levels, config=cfg)
        sync()
        return args.iters * batch / (time.perf_counter() - t0)

    print(f"devices: {n_dev} x {kind}; {H}x{W}, {levels} levels")
    base = run(1)
    print("batch  fps        speedup  efficiency")
    print(f"{1:5d} {base:10.1f} {1.0:8.2f} {'100%':>10}")
    for batch in (2, 4, 8, 16):
        fps = run(batch)
        print(f"{batch:5d} {fps:10.1f} {fps/base:8.2f} {fps/base/batch:9.0%}")

    from optical_flow_tpu_torch.parallel import flow_mesh, mesh_factorization, sharded_coarse_to_fine

    if n_dev >= 2:
        # the home device holds the inputs, and the mesh's first slot is it
        devices = [device] + [torch.device("cuda", i) for i in range(n_dev) if i != device.index]
    else:
        devices = [device] * MESH_SLOTS
    f, r, c = mesh_factorization(len(devices))
    mesh = flow_mesh(frames=f, rows=r, cols=c, devices=devices)
    fast = dataclasses.replace(VideoConfig.fast().flow, levels=levels)
    rng = np.random.RandomState(0)
    a = rng.rand(H, W).astype(np.float32)
    a, b = as_tensor(a, device), as_tensor(np.roll(a, 2, axis=-1), device)
    u, v = sharded_coarse_to_fine(a, b, mesh, levels, config=fast)
    u0, v0 = coarse_to_fine(a, b, levels, config=fast)
    sync()
    if not (torch.equal(u, u0) and torch.equal(v, v0)):
        d = max(float((u - u0).abs().max()), float((v - v0).abs().max()))
        print(f"sharded pyramid over mesh (frames={f}, rows={r}, cols={c}): "
              f"differs from the unsharded controller by {d:.3g}")
        return 1
    print(f"sharded pyramid over mesh (frames={f}, rows={r}, cols={c}): OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
