"""Serving runtime: the wave-serving core, its adapters, the replica
fleet and fault injection."""
