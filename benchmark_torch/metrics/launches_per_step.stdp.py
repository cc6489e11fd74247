"""``launches_per_step.stdp``: device operations (kernels, copies, memsets)
in the profiled window over the steps its trials simulated, PyTorch's own
launches included, in the HPC benchmark network's cell. Moves
``ei_40k_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.launches_per_step
