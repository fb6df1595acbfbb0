"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

A second package beside ``ray_tpu`` (the JAX reference, which it never
imports). This slice ports single-GPU GPT-2 training: the model
(``models``), attention on hand-written CUDA flash kernels (``ops``),
the train step, AdamW and the input prefetcher (``train``), and device
detection (``core``). Entry points run on the card by default and raise
when none is visible; ``device="cpu"`` runs them on the CPU with the
kernels' plain versions.
"""

__version__ = "0.1.0"
