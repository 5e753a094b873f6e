"""Serving runtime: the wave-serving core and the CapsNet adapter."""
