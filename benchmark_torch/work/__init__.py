"""The work of each configuration's trials, one module each: the
operations and bytes a trial needs, whatever kernel computes it."""
