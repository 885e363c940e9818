"""Snapshot keys: per-config source fingerprints and the encoding epoch."""
