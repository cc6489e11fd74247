"""``launches_per_step.cuba``: device operations (kernels, copies, memsets)
in the profiled window over the steps its trials simulated, PyTorch's
own launches included. Moves ``cuba_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.launches_per_step
