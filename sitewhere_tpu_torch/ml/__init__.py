"""Anomaly-model compiler (tiny scorers -> weight tables)."""
