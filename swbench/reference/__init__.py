"""The plain reference of the port's step semantics.

Frozen copies of the port's plain torch modules (each file names the port
module it mirrors and the commit it was frozen at), plus `world.py`, which
compiles the benchmark's world into step params, and `replay.py`, which
computes what the port must answer. Nothing here imports the port or JAX.
"""
