"""Dynamic-routing kernels for Hopper (``kernel.py``), their public
entry points (``ops.py``), the eager oracle (``ref.py``) and the spec
vocabulary (``vocab.py``)."""
