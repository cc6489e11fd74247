"""The least time a piece of work needs on an H100.

Published peaks of the H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit; a card set below it runs slower, so a run prints its
``power.limit`` beside every share): float32 outside the tensor cores at
67 TFLOP/s, which counts a fused multiply-add as two operations, and HBM
at 3.35 TB/s. The same operation rate is used for the integer and compare
work of a step: one such operation takes a lane a whole cycle, where the
peak credits an FMA's two operations to one, so the bound stays a bound.
"""

FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float):
    """``(seconds, 'operations' or 'bytes')``: the larger of *ops* over the
    operation peak and *nbytes* over the memory peak, and which it is."""
    t_ops = ops / FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')
