"""``launches_per_step.hh``: device operations (kernels, copies, memsets)
in the profiled window over the steps its trials simulated, PyTorch's own
launches included, in the Hodgkin-Huxley network's cell (``coba_hh``).
Moves ``ei_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.launches_per_step
