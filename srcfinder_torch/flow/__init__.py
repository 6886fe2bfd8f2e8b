"""Flightline workflow: the one-command pipeline, the IME stage, and the
emission stage (wind grids, nearest-cell wind statistics, emission rates,
msf-flow)."""
