"""Ingest lanes: wire bytes -> packed batches (the bulk fast lane)."""
