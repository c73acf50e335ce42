"""Monocular scale-drift demo (port of examples/scale_drift.py): why loop
closure needs Sim(3), not SE(3).

A monocular odometry chain measures every relative pose correctly EXCEPT
for a compounding per-step scale error (each keyframe's local map is
slightly smaller than its predecessor's). Integrated around a loop, the
trajectory spirals inward. One true-scale loop edge then:

- on the SE(3) pose graph: corrects rotation and translation direction
  but has no scale degree of freedom — the spiral survives;
- on the Sim(3) pose graph (what `incremental_slam` runs, with the edge
  scale measured by `measure_loop_sim3`'s Umeyama alignment): the
  per-node log-scale drift is spread around the cycle like any other
  residual, and the geometry is recovered.

Prints mean/final center error for drifted / SE(3)-closed / Sim(3)-closed.

  python -m optical_flow_tpu_torch.examples.scale_drift [--n 16] [--gamma 0.93] [--device cpu]
"""

import argparse
import sys

import numpy as np


def circle_trajectory(N, radius=5.0):
    Rs, ts = [], []
    for k in range(N):
        th = 2 * np.pi * k / N
        c, s = np.cos(th), np.sin(th)
        Rw = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        cw = np.array([radius * s, 0.0, -radius * c], np.float32)
        Rs.append(Rw)
        ts.append(-Rw @ cw)
    return np.stack(Rs), np.stack(ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16, help="keyframes on the loop")
    ap.add_argument("--gamma", type=float, default=0.93,
                    help="per-step scale drift (each step's map is gamma x)")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from optical_flow_tpu_torch.slam.pose_graph import (
        PoseGraph,
        Sim3PoseGraph,
        relative_pose,
        sim3_compose,
    )
    from optical_flow_tpu_torch.utils.device import canonical_device

    device = canonical_device(args.device)
    Rs_true, ts_true = circle_trajectory(args.n)
    true_c = np.stack([-R.T @ t for R, t in zip(Rs_true, ts_true)])

    # odometry edges: correct (R, t) but carrying the scale error gamma
    edges = []
    for i in range(args.n - 1):
        R_ij, t_ij = relative_pose(Rs_true[i], ts_true[i],
                                   Rs_true[i + 1], ts_true[i + 1])
        edges.append((args.gamma, R_ij, t_ij))
    S = [(1.0, Rs_true[0], ts_true[0])]
    for m in edges:
        S.append(sim3_compose(m, S[-1]))
    ss0 = np.asarray([s for s, _, _ in S], np.float32)
    Rs0 = np.stack([R for _, R, _ in S]).astype(np.float32)
    ts0 = np.stack([t for _, _, t in S]).astype(np.float32)

    def errs(centers):
        e = np.linalg.norm(centers - true_c, axis=1)
        return e.mean(), e[-1]

    drift_c = np.stack([-(R.T @ t) / s for s, R, t in zip(ss0, Rs0, ts0)])
    m0, f0 = errs(drift_c)
    print(f"drifted (gamma={args.gamma}, {args.n} keyframes): "
          f"mean center error {m0:.3f}, endpoint {f0:.3f} "
          f"(node scale decays to {ss0[-1]:.2f})")

    # the true-scale loop edge both graphs receive
    R_lc, t_lc = relative_pose(Rs_true[0], ts_true[0],
                               Rs_true[-1], ts_true[-1])

    # SE(3)-equivalent of the drifted trajectory: t/s preserves each
    # camera's center (-R^T t/s == the drifted center), so the SE(3)
    # baseline starts from exactly the trajectory printed above
    g3 = PoseGraph.from_odometry(Rs0, ts0 / ss0[:, None])
    g3.add_edge(0, args.n - 1, R_lc, t_lc, weight=4.0)
    Rse, tse = g3.optimize(iters=20, device=device)
    m3, f3 = errs(np.stack([-R.T @ t for R, t in zip(Rse, tse)]))
    print(f"SE(3) closure:  mean {m3:.3f}, endpoint {f3:.3f} "
          f"(no scale dof — the spiral survives)")

    g7 = Sim3PoseGraph(ss=ss0.copy(), Rs=Rs0.copy(), ts=ts0.copy())
    for i, (s_m, R_m, t_m) in enumerate(edges):
        g7.add_edge(i, i + 1, s_m, R_m, t_m)
    g7.add_edge(0, args.n - 1, 1.0, R_lc, t_lc, weight=4.0)
    ss, Rsi, tsi = g7.optimize(iters=20, device=device)
    m7, f7 = errs(g7.centers(ss, Rsi, tsi))
    print(f"Sim(3) closure: mean {m7:.3f}, endpoint {f7:.3f} "
          f"(node scales lifted back to {ss[-1]:.2f})")
    print(f"SE(3) / Sim(3) mean-error ratio: {m3 / max(m7, 1e-9):.0f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
