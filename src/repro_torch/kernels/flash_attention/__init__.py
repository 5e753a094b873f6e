"""Causal GQA flash attention for Hopper: the launch wrapper and its plain
version (``kernel.py``), the entry points with the reference's block rule
(``ops.py``) and the dense oracle (``ref.py``)."""
