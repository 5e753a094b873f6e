"""The paper's §5.2.2 PE special-function unit as an elementwise kernel:
the launch wrapper and its plain version (``kernel.py``), the
shape-generic entry points ``exp`` / ``inv_sqrt`` / ``reciprocal``
(``ops.py``) and the exact oracles (``ref.py``)."""
