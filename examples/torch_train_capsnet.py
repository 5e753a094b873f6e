"""End-to-end CapsNet training on the PyTorch/CUDA port, on the H100
(``--device cpu`` for the CPU): a few hundred steps on the synthetic
class-conditional dataset with the full substrate — AdamW + schedule,
routing-mode selection, async checkpointing, straggler watchdog,
step-indexed resume.

The twin of ``train_capsnet.py``.  The port's driver is the CLI
``repro_torch.launch.train_capsnet`` (the same flags, plus ``--device``);
this file runs it, and ``main`` returns what it prints (the step it
resumed from, each step's loss and accuracy, the eval accuracy).

    PYTHONPATH=src python examples/torch_train_capsnet.py --steps 200
    PYTHONPATH=src python examples/torch_train_capsnet.py --steps 300
    # the second run resumes from the first's last checkpoint
    PYTHONPATH=src python examples/torch_train_capsnet.py --smoke \\
        --routing fused

``--routing fused`` trains through the routing procedure kernel and its
recompute-b backward kernel — the backward replays the routing loop
instead of keeping per-iteration residuals.
"""
from repro_torch.launch.train_capsnet import main

if __name__ == "__main__":
    main()
