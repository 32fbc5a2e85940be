"""Operational tools: parity checks, weight acquisition, diagnostics."""
