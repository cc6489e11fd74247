"""Small traffic for the CPU tests: the cells' mixes at a tenth of a
second of simulated time on a few hundred neurons."""

TRIALS = dict(kind='trials', scale=0.25, trial_steps=300, initial_states=3,
              warm_steps=20, trace_trials=1, check_trials=2)
SEED = 2 ** 31 + 12345
