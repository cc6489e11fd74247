"""Plain reference of ``jitc_coba_ei``: the Brette COBA network over
just-in-time connectivity, in plain PyTorch float32 (TF32 off).

Each projection (excitatory rows ``0 .. n_exc``, inhibitory rows ``n_exc
.. num``, each onto all ``num`` neurons) is the upstream ``JITCNormalR``
matrix: connection probability ``prob = n_conn / num`` and per-edge
weights ``Normal(w, 0.1 w)``, sampled by the light-RNG walk from the
projection's seed. This module samples the whole matrix once, as an
explicit list of edges, by that algorithm:

- one xorshift32 stream per ``(row, chunk, lane)``, ``lane < 32``, four
  chunks of ``ceil(num / 4)`` columns, seeded by a hash of ``(seed, row,
  chunk, lane)``;
- each stream starts at a stationary residual ``q`` (rejection sampling,
  two draws a round) and visits column ``chunk * chunk_size + lane + 32
  q`` while that lies inside its chunk, with geometric skips ``q += 1 +
  bounded(next, cl - 1)``, ``cl = max(ceil(float32(2 / prob)), 2)``;
- the weight of edge ``(row, col)`` is ``fma(z, 0.1 w, w)`` with ``z``
  Acklam's inverse normal CDF of a 24-bit hash of ``(seed, row, col)``.

uint32 arithmetic is done in int64 and masked back to 32 bits; a product
of two 32-bit values is taken from 16-bit limbs, so no int64 product
overflows. A step then spikes as :mod:`lif_ei` sets out, and each spike
of row ``i`` adds the weights of its edges to their columns' input (float
sums in no fixed order, as the program's). Trials of this chaotic network
are compared by population statistics, not bit for bit.
"""

import math

import numpy as np
import torch

from benchmark_torch.reference.lif_ei import (
    initial_states, params, run, sizes)

M32 = 0xFFFFFFFF
STRIDE = 32
CHUNKS = 4
ZERO_ESCAPE = 0x6D2B79F5


# -- the light RNG, uint32 in int64

def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for uint32 *x* and a constant *c*."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & M32


def _mulhi(a: torch.Tensor, b) -> torch.Tensor:
    """``floor(a * b / 2^32)`` for uint32 *a* and *b*."""
    return (a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)) >> 16


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def _next(x: torch.Tensor) -> torch.Tensor:
    """xorshift32 (13, 17, 5); a zero state escapes to a constant."""
    x = x ^ ((x << 13) & M32)
    x = x ^ (x >> 17)
    x = x ^ ((x << 5) & M32)
    return torch.where(x == 0, ZERO_ESCAPE, x)


def _stream_seed(seed: int, row, chunk, lane) -> torch.Tensor:
    x = (seed ^ 0xD1B54A35) ^ _mul(row, 0x85EBCA6B)
    x = x ^ _mul(chunk, 0xC2B2AE35) ^ _mul(lane, 0x27D4EB2D)
    x = _mix(x)
    return torch.where(x == 0, ZERO_ESCAPE, x)


def _uniform(seed: int, row, col) -> torch.Tensor:
    """The 24-bit uniform in [0, 1) of edge ``(row, col)``."""
    h = _mix((seed ^ 0xA0761D65) ^ _mul(row, 0xE7037ED1)
             ^ _mul(col, 0x8EBC6AF1))
    return (h & 0xFFFFFF).to(torch.float32) * (1.0 / 16777216.0)


# Acklam's rational approximation of the inverse normal CDF, its
# coefficients in float32 (central region, then the tails)
_A = (-39.696830, 220.94609, -275.92851, 138.35775, -30.664799, 2.5066283)
_B = (-54.476099, 161.58584, -155.69898, 66.801312, -13.280681, 1.0)
_C = (-0.007784894, -0.32239646, -2.4007583, -2.5497325, 4.3746641,
      2.9381640)
_D = (0.007784696, 0.32246713, 2.4451342, 3.7544087, 1.0)
_LOW, _HIGH = 0.02425, 0.97575


def _horner(coefs, x: torch.Tensor) -> torch.Tensor:
    """The polynomial by Horner's rule, one FMA a step."""
    acc = torch.full_like(x, coefs[0])
    for c in coefs[1:]:
        acc = torch.addcmul(torch.full_like(x, c), acc, x)
    return acc


def _tail_q(u: torch.Tensor) -> torch.Tensor:
    """``sqrt(-2 log u)``: the log taken in float64 and rounded, the
    square root correctly rounded."""
    log = torch.log(torch.clamp(u, min=1e-30).double()).float()
    return torch.sqrt((-2.0 * log).double()).float()


def _normal(u: torch.Tensor) -> torch.Tensor:
    u = torch.clamp(u, 1e-10, 1.0 - 1e-10)
    v = u - 0.5
    r = v * v
    central = _horner(_A, r) * v / _horner(_B, r)
    lo, hi = _tail_q(u), _tail_q(1.0 - u)
    return torch.where(
        u < _LOW, -(_horner(_C, lo) / _horner(_D, lo)),
        torch.where(u > _HIGH, _horner(_C, hi) / _horner(_D, hi), central))


# -- the sampled matrix

def conn_length(prob: float) -> int:
    """``cl = max(ceil(float32(2 / prob)), 2)``."""
    return max(int(math.ceil(np.float32(2.0 / prob))), 2)


def walk_edges(seed: int, n_rows: int, n_cols: int, prob: float, device):
    """``(rows, cols)`` of every edge of the matrix, int64."""
    chunk_size = max(1, -(-n_cols // CHUNKS))
    n_chunks = -(-n_cols // chunk_size)
    per_row = n_chunks * STRIDE
    n = conn_length(prob) - 1
    rows = torch.arange(n_rows, device=device).repeat_interleave(per_row)
    sub = torch.arange(per_row, device=device).repeat(n_rows)
    chunk, lane = sub // STRIDE, sub % STRIDE
    state = _stream_seed(seed & M32, rows, chunk, lane)
    q = torch.zeros_like(state)
    idx = torch.arange(state.numel(), device=device)
    st = state
    while idx.numel():
        s1 = _next(st)
        cand = _mulhi(s1, n)
        s2 = _next(s1)
        accept = _mulhi(s2, n) < (n - cand)
        state[idx] = s2
        q[idx[accept]] = cand[accept]
        idx, st = idx[~accept], s2[~accept]
    start = chunk * chunk_size
    width = torch.clamp(n_cols - start, max=chunk_size)
    out_rows, out_cols = [], []
    while rows.numel():
        local = (lane + STRIDE * q) & M32
        live = local < width
        rows, lane = rows[live], lane[live]
        start, width = start[live], width[live]
        state, q, local = state[live], q[live], local[live]
        out_rows.append(rows)
        out_cols.append(start + local)
        state = _next(state)
        q = (q + 1 + _mulhi(state, n)) & M32
    return torch.cat(out_rows), torch.cat(out_cols)


def edge_weights(seed: int, rows, cols, loc: float, scale: float):
    """``fma(z, scale, loc)`` per edge, in float32."""
    z = _normal(_uniform(seed & M32, rows, cols))
    return torch.addcmul(torch.full_like(z, loc), z,
                         torch.full((), scale, device=z.device))


def projection(seed: int, n_rows: int, num: int, prob: float, w: float,
               device) -> dict:
    """One projection's edges: presynaptic row, column, float32 weight."""
    rows, cols = walk_edges(seed, n_rows, num, prob, device)
    loc, scale = float(np.float32(w)), float(np.float32(0.1 * w))
    return dict(rows=rows, cols=cols,
                w=edge_weights(seed, rows, cols, loc, scale),
                out_degree=torch.bincount(rows, minlength=n_rows))


def matrix(cfg: dict, inputs: dict) -> dict:
    """Both projections of the network (sampled once, then kept in
    *inputs*)."""
    if 'matrix' not in inputs:
        net, num = cfg['network'], inputs['num']
        prob = min(1.0, net['n_conn'] / num)
        seed, device = inputs['net_seed'], inputs['device']
        inputs['matrix'] = dict(
            e=projection(seed, inputs['n_exc'], num, prob, net['w_e'],
                         device),
            i=projection(seed + 1, num - inputs['n_exc'], num, prob,
                         net['w_i'], device))
    return inputs['matrix']


# -- the benchmark's interface

def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The walk seed and the trials' initial states from *seed*: the
    program samples the connectivity itself, from that walk seed."""
    n_exc, _, num = sizes(cfg, traffic['scale'])
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    net_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                 device=device))
    states = initial_states(cfg, num, traffic['initial_states'], gen, device)
    return dict(program={'seed': net_seed}, net_seed=net_seed, n_exc=n_exc,
                num=num, states=states, device=device)


def simulate(cfg: dict, traffic: dict, inputs: dict, state: dict,
             n_steps: int, dtype=torch.float32) -> dict:
    """One trial of *n_steps* from *state*; returns the final state."""
    m = matrix(cfg, inputs)
    n_exc, num = inputs['n_exc'], inputs['num']

    def propagate(spike):
        spike = spike.to(torch.float32)
        out = []
        for proj, s in ((m['e'], spike[:n_exc]), (m['i'], spike[n_exc:])):
            acc = torch.zeros(num, dtype=torch.float32, device=spike.device)
            out.append(acc.index_add_(0, proj['cols'],
                                      proj['w'] * s[proj['rows']]))
        return out[0], out[1], None
    return run(state, params(cfg), n_steps, lambda cap: propagate, cap=num,
               dtype=dtype)


def compare(cfg: dict, inputs: dict, got: dict, want: dict) -> dict:
    """Population statistics of a trial against the reference's:
    ``spikes_gap_e`` and ``spikes_gap_i``, the relative gap of each
    population's total spike count. (The per-neuron counts' gap does not
    separate a sound run from the control: one spike decided otherwise
    moves it as far as bfloat16 does, PERF.md 2.)"""
    w = want['spike_count'].double()
    g = got.get('spike_count')
    if g is None or g.shape != w.shape:
        return dict(spikes_gap_e=float(w.numel()),
                    spikes_gap_i=float(w.numel()))
    g = g.to(w.device).double()
    n_exc = inputs['n_exc']
    out = {}
    for name, part in (('spikes_gap_e', slice(0, n_exc)),
                       ('spikes_gap_i', slice(n_exc, None))):
        total = float(w[part].sum())
        out[name] = abs(float(g[part].sum()) - total) / max(total, 1.0)
    return out
