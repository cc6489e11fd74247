"""``ei_40k_us_per_step``: wall-clock microseconds a simulated step of
the ``coba_ei`` cells whose table fits in the card's L2 on K21's grid
route (``coba_ei.40k``): all the steps of the window's trials over the
window's whole wall time, by the host clock."""

from benchmark_torch.harness import readers

read = readers.us_per_step
