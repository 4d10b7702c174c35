"""Ops of the port: attention, flax-numerics layers, the fused tails."""
