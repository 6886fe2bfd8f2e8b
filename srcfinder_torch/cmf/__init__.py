"""Columnwise robust matched filter (CMF)."""
