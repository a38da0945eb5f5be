"""Hand-written CUDA kernels of the mg-CG main path and their plain
PyTorch versions.

Every wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors (or raises); ``launches`` counts, per wrapper,
the kernel launches since the caller last cleared it.
"""

from collections import Counter

launches: Counter = Counter()
