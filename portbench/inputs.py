"""The input arrays of the configurations, made on the device from `--seed`.

A configuration's "input" gives the parameters of one generator, Zipf by
rejection-inversion (Hoermann & Derflinger 1996; the sampler of the
reference coder's include/zipf_dist.hpp): Zipf(exponent) over
{1..universe}, less `shift`, clipped to `clip` (null: no clip).  The main
path's input is bench.py's make_data, NumPy's unbounded Zipf(1.25) less 1
clipped to 2^28 - 1, here with the universe 2^52 in place of NumPy's
int64 range; the large-alphabet input zipf20 is Zipf(1) over 2^20.

A configuration keeps a pool of arrays resident (`assumed.pool`): the
pool is drawn from one torch.Generator on the device, seeded by `--seed`,
in a few large float64 calls an array, and handed to the host as u32
arrays.  Every seed draws the same number of values of the same
distribution.

A sharded configuration (a mix with `shards`) holds each array of the
pool over several processes: a process draws only its shard of each
array, from a generator of its own seeded by (seed, rank), so that the
shards together are n independent draws of the distribution
(`shard`).
"""

from __future__ import annotations

import numpy as np
import torch


def pool_size(config: dict) -> int:
    return int(config["assumed"]["pool"])


def generator(seed: int, device) -> torch.Generator:
    """The generator of a seed: any whole number, negative ones too."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def _H(x: torch.Tensor, q: float) -> torch.Tensor:
    if abs(q - 1.0) < 1e-8:
        return torch.log(x)
    return (torch.pow(x, 1.0 - q) - 1.0) / (1.0 - q)


def _H_inv(u: torch.Tensor, q: float) -> torch.Tensor:
    if abs(q - 1.0) < 1e-8:
        return torch.exp(u)
    return torch.pow(torch.clamp(1.0 + u * (1.0 - q), min=1e-300),
                     1.0 / (1.0 - q))


def zipf(g: torch.Generator, n: int, exponent: float, universe: int,
         shift: int = 0, clip: int | None = None) -> np.ndarray:
    """n draws from Zipf(exponent) over {1..universe}, less `shift`,
    clipped to [0, clip]: u uniform on [H(1.5) - 1, H(universe + 0.5)],
    x = H^-1(u), accept k = round(x) when u >= H(k + 0.5) - k^-q."""
    q, dev = exponent, g.device
    f64 = torch.float64
    lo = float(_H(torch.tensor(1.5, dtype=f64), q)) - 1.0
    hi = float(_H(torch.tensor(universe + 0.5, dtype=f64), q))
    out = torch.empty(n, dtype=torch.int64, device=dev)
    filled = 0
    while filled < n:
        m = max(1024, int((n - filled) * 1.25))
        u = lo + torch.rand(m, generator=g, dtype=f64, device=dev) * (hi - lo)
        k = torch.clamp(torch.round(_H_inv(u, q)), 1.0, float(universe))
        got = k[u >= _H(k + 0.5, q) - torch.pow(k, -q)][:n - filled]
        out[filled:filled + got.numel()] = got.to(torch.int64)
        filled += got.numel()
        del u, k, got
    out = torch.clamp(out - shift, min=0, max=clip)
    return out.cpu().numpy().astype(np.uint32)


def make(config: dict, seed: int, device, n: int | None = None,
         count: int | None = None) -> list:
    """The configuration's pool for `seed`: `count` (default the pool
    size) host u32 arrays of config["n"] values, or `n`, drawn on
    `device`.  A smaller count gives the first arrays of the pool."""
    g = generator(seed, device)
    size = int(n or config["n"])
    return [zipf(g, size, **config["input"])
            for _ in range(count or pool_size(config))]


def shard(config: dict, seed: int, rank: int, length: int, device,
          count: int | None = None) -> list:
    """Process `rank`'s shards of the pool for `seed`: `count` (default
    the pool size) host u32 arrays of `length` values, drawn on `device`
    from the generator of (seed, rank)."""
    (word,) = np.random.SeedSequence([seed % (1 << 64), rank]
                                     ).generate_state(1, np.uint64)
    g = generator(int(word), device)
    return [zipf(g, length, **config["input"])
            for _ in range(count or pool_size(config))]
