"""``setup_s``: seconds from the start of the process to the first timed
step: imports, CUDA initialisation, loading (the first run in a
checkout: building) the kernel library, the inputs, the network and one
warm trial."""

from benchmark_torch.harness import readers

read = readers.setup_s
