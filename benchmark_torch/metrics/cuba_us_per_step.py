"""``cuba_us_per_step``: wall-clock microseconds a simulated step of the
``cuba_ei`` cells (``cuba_ei.400k``): all the steps of the window's
trials over the window's whole wall time, by the host clock."""

from benchmark_torch.harness import readers

read = readers.us_per_step
