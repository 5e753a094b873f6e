"""The Mamba-1 selective scan for Hopper: the launch wrapper and its plain
version (``kernel.py``), the entry point with the reference's chunk rule
(``ops.py``) and the oracle (``ref.py``)."""
