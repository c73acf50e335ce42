"""Utilities of the port: kernel timing and rooflines on the card (profiling),
and where an entry point's inputs go (device)."""
