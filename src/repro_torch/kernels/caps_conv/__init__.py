"""The PrimaryCaps convolution for Hopper: the launch wrapper, its
geometry and its plain version (``kernel.py``), the differentiable entry
point the encoder calls (``ops.py``) and the float64 oracle (``ref.py``)."""
