"""Durable state: crash-safe writes and the engine's checkpoints."""
