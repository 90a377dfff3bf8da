"""Deterministic fault injection (port of ``repro.robustness``)."""
