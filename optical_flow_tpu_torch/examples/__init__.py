"""The example scripts of the JAX package's ``examples/``, ported: each is
a module with ``main(argv=None)`` that returns the exit code, runnable as

    python -m optical_flow_tpu_torch.examples.<name> [--device cpu] ...

Each keeps its JAX script's flags, printed lines and files, with
``--device`` (default ``cuda``; ``cpu`` runs the plain versions) in place
of ``--cpu``; without a card, ``--device cuda`` raises.

| Module | What it shows |
|---|---|
| ``loop_closure`` | odometry chain -> place recognition -> verified loop edge -> pose-graph closure |
| ``scale_drift`` | why monocular loop closure is Sim(3): SE(3) keeps the scale spiral, Sim(3) removes it |
| ``stereo_slam`` | a rectified rig makes the map metric (``incremental_slam`` mono and stereo) |
| ``vi_odometry`` | tightly-coupled VI refinement: biases, alignment, joint VI-BA |
| ``sfm_demo`` | multi-view structure from motion on a rendered scene or a video |
| ``video_gesture`` | decode -> preprocess -> pyramidal flow -> gesture, per-frame lines and PNG dumps |
| ``live_gesture`` | the same loop on live sources (V4L2 camera, ``pipe:``, file) by ``push`` |
| ``sparse_track`` | Shi-Tomasi corners + pyramidal sparse LK (of.cpp) |
| ``trajectory`` | tracks -> RANSAC homography -> cumulative camera translation |
| ``stabilize`` | homography-chain stabilization with the engine's remap |
| ``pair_scrub`` | the legacy frame-pair scrubbing demo, arrows rendered per pair |
| ``serve_stream`` | a ``FlowClient`` streaming a video to a running ``FlowServer`` |
| ``scaling_report`` | frame-batch scaling on the card and the sharded pyramid over the host's cards (or 4 slots of one) |
| ``still_regression`` | the reference's four goldens at 1e-6 (float64), or the float32 EPE report |
"""
