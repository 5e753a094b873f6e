"""Paper §2 core: the §5.2.2 approximations, dynamic routing, the Router,
the §4 pipeline and the CapsNet layers (PyTorch port)."""
