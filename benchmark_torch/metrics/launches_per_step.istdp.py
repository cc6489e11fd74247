"""``launches_per_step.istdp``: device operations (kernels, copies, memsets)
in the profiled window over the steps its trials simulated, PyTorch's own
launches included, in the cell of Vogels et al. 2011's network. Moves
``ei_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.launches_per_step
