"""Flightline workflow: the one-command pipeline and the IME stage."""
