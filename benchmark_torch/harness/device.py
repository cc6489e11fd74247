"""The card a run measures on: refuse a host without one, and describe it.

A run that finds no CUDA device, or fewer than its cell asks for, stops
before it prints a result: it never falls back to the CPU.
"""

import subprocess

import torch


class NoDevice(RuntimeError):
    """The host lacks the CUDA devices a cell needs."""


def require_cuda(chips: int) -> torch.device:
    """The first CUDA device, when the host has at least *chips* of them."""
    if not torch.cuda.is_available():
        raise NoDevice('torch.cuda.is_available() is false: this benchmark '
                       'measures the CUDA port and runs only on a card')
    count = torch.cuda.device_count()
    if count < chips:
        raise NoDevice(f'the cell needs {chips} CUDA devices, the host has '
                       f'{count}')
    return torch.device('cuda', 0)


def power_limit() -> str:
    """``name, power.limit`` of the first card as ``nvidia-smi`` reads
    them, or why they could not be read."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi failed: {e}'
    if out.returncode != 0:
        return f'nvidia-smi failed: {out.stderr.strip()}'
    return out.stdout.strip().splitlines()[0]


def describe(device: torch.device, count: int) -> dict:
    """The result line's ``device`` entry, without the memory peak."""
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
            'count': count}


def sync(device: torch.device) -> None:
    """Wait for the work queued on *device* (none to wait for on a CPU)."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
