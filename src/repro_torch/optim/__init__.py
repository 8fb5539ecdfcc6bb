"""Optimizers of the port (momentum SGD, the paper's Eq. 1)."""
