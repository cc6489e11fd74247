# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Random-number generators of the implicit-connectivity sampler
(``brainevent_tpu.rng``): the light RNG. The LFSR generators
(``rng/lfsr.py``, ``rng/scalar.py``) are not ported yet."""

from .light import (
    light_rng_mix32, light_rng_bounded, light_rng_next, light_rng_init,
    light_rng_uniform01, light_rng_normal01, light_rng_initial_q,
)

__all__ = [
    'light_rng_mix32', 'light_rng_bounded', 'light_rng_next',
    'light_rng_init', 'light_rng_uniform01', 'light_rng_normal01',
    'light_rng_initial_q',
]
