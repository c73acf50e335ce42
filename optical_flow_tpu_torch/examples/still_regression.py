"""Still-image golden regression (port of examples/still_regression.py),
the reference's serialOrig / SerialPyr.

Loads the reference's table1/table2 pair (cropped to 640x448, /255 —
serialOrig.cpp:538-545), runs single-level and 7-level pyramidal dense LK,
writes the flow fields in saveMat format, and compares against the golden
files at the reference's own 1e-6 threshold (serialOrig.cpp:588). The
float64 oracle runs on the CPU whatever ``--device`` says; ``--f32`` runs
in float32 on ``--device`` and reports EPE instead. Needs a checkout of
the reference (``--reference`` or OPTICAL_FLOW_REFERENCE_DIR).

  python -m optical_flow_tpu_torch.examples.still_regression [--reference DIR] [--out DIR] [--f32] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default=None)
    ap.add_argument("--out", default=None, help="write U2/V2/UPyr/VPyr .txt dumps here")
    ap.add_argument("--f32", action="store_true",
                    help="run in float32 (the card's dtype) and report EPE instead")
    ap.add_argument("--device", default="cuda", help="torch device of --f32 (default: the card)")
    args = ap.parse_args(argv)

    if args.reference:
        os.environ["OPTICAL_FLOW_REFERENCE_DIR"] = args.reference

    from optical_flow_tpu_torch import FlowConfig, coarse_to_fine, lucas_kanade
    from optical_flow_tpu_torch.utils import goldens
    from optical_flow_tpu_torch.utils.device import as_tensor, canonical_device, host_array

    ref = goldens.reference_dir()
    if ref is None:
        sys.exit("reference checkout not found (set --reference)")
    # the float64 oracle runs on the CPU
    device = canonical_device(args.device if args.f32 else "cpu")
    img1, img2 = goldens.load_table_pair()
    dtype = np.float32 if args.f32 else np.float64
    a = as_tensor(img1.astype(dtype), device)
    b = as_tensor(img2.astype(dtype), device)

    impl = "auto" if args.f32 else "torch"
    cfg = FlowConfig(impl=impl)
    u2, v2 = lucas_kanade(a, b, impl=impl)
    up, vp = coarse_to_fine(a, b, config=cfg)

    checks = [
        ("U2Test.txt", u2), ("V2Test.txt", v2),
        ("UPyrTest.txt", up), ("VPyrTest.txt", vp),
    ]
    failed = False
    for name, got in checks:
        got = host_array(got).astype(np.float64)
        want = goldens.load_mat(ref / name)
        err = np.abs(got - want)
        if args.f32:
            print(f"{name}: mean EPE {err.mean():.6f} px, max {err.max():.6f} px "
                  f"({'OK' if err.mean() <= 0.1 else 'FAIL'} vs 0.1 px budget)")
            failed |= err.mean() > 0.1
        else:
            ok = err.max() <= 1e-6
            print(f"{name}: max abs err {err.max():.2e} ({'OK' if ok else 'FAIL'} vs 1e-6)")
            failed |= not ok
        if args.out:
            goldens.save_mat(got, os.path.join(args.out, name))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
