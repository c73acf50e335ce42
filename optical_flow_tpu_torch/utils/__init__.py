"""Utilities of the port: kernel timing and rooflines on the card (profiling)."""
