"""Utilities of the port: kernel timing and rooflines on the card (profiling),
where an entry point's inputs go (device), and the evaluation formats
(interop: .flo, KITTI flow PNG, TUM trajectories, ATE and RPE)."""
