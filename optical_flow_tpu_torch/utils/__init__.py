"""Utilities of the port: timing, tracing and rooflines on the card
(profiling), where an entry point's inputs go (device), metrics, the
numerical and stall guard, checkpoints, image loading, the reference's
golden-file format, visualisation, and the evaluation formats (interop:
.flo, KITTI flow PNG, TUM trajectories, ATE and RPE)."""
