"""Hand-written CUDA kernels of the mg-CG main path and their plain
PyTorch versions.

Every wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors (or raises); ``launches`` counts, per wrapper and
storage type, the kernel launches since the caller last cleared it: the
f32 instantiation under the wrapper's name, the others with a suffix
(``apply_stencil5.f64``, ``visit_down.bf16``).
"""

from collections import Counter

import torch

launches: Counter = Counter()

_SUFFIX = {torch.float32: "", torch.float64: ".f64", torch.bfloat16: ".bf16"}


def count_launch(name: str, dtype: torch.dtype) -> None:
    """One launch of wrapper ``name``'s kernel instantiated for ``dtype``."""
    launches[name + _SUFFIX[dtype]] += 1
