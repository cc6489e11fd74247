"""``ei_small_us_per_step``: the same rate for the small ``coba_ei`` cells
(``coba_ei.4k``), whose runs spread wider: the entry's host work a trial
is a few percent of it, and the host's speed varies from run to run."""

from benchmark_torch.harness import readers

read = readers.us_per_step
