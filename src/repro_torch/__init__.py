"""PyTorch/CUDA port of the PIM-CapsNet serving path.

Laid out like the JAX package ``repro`` (which stays the reference the port
is tested against): ``core/`` (approximations, routing, router, pipeline,
capsule layers), ``kernels/routing/`` (the hand-written CUDA routing kernels
for Hopper, their plain PyTorch versions and the public wrappers),
``models/``, ``runtime/`` (the wave-serving core and the CapsNet adapter),
``launch/`` (the serving CLI), ``configs/`` and ``data/``.  ``convert``
carries weights across from the JAX package's parameter tree.

The port imports ``torch`` and numpy only, never JAX or ``repro``.  Entry
points default to ``device="cuda"`` and raise when no CUDA device is
present; tests pass ``device="cpu"``, where every kernel wrapper runs its
plain PyTorch version.
"""
