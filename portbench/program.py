"""The system under test: ans_tpu_torch's prepared calls, staged for a cell.

`stage` and `decoded_values` are the program side of the codec `lane`
(portbench/manifest.py); another codec's are in codecs/<codec>.py and
return this module's `Staged`.  `join`, `local_slice` and
`launch_counts` serve every codec.

The set-up stages one prepared call for each array of the configuration's
pool: for a decode mix it encodes the array once (the blob a user stores;
its model-half seconds come from the program's own `utils.stats` record)
and prepares a decoder of that blob; for an encode mix it prepares an
encoder of the array, whose first call writes the blob.  One stream
(`models.prepare_decoder` / `models.prepare_encoder`) or a blocked
container of `sections` sections (`parallel.BlockCodec`).  A sharded mix
(`shards`) stages, on each rank, its shard of every array: encoded by
`parallel.multihost.MultiHostBlockCodec.encode_local`, whose model comes
from the histogram summed over the ranks (the program's own
all-reduces), and decoded by that codec's `BlockCodec.prepare_decoder`;
its model half is the self time of the program's `model.build` spans
(`BlockCodec._front`, less its `tables` and `stage`), recorded under
`utils.stats.tracing()` while the shards are staged.
A request is one call of the next staged object, on device-resident
data.  The benchmark reads the program's launch counters and nothing
else of it; the ranks join the program's own process group (`join`) and
find their shards' bounds through it (`local_slice`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


@dataclass
class Staged:
    kind: str                 # "decode" or "encode"
    calls: list               # one per array of the pool: one request
    blobs: list               # the set-up's blob of each array
    sections: int             # 0: one stream; D: a container of D
    model_build_ns: int | None = None  # the program's model half over the
    #                                    pool, where it records one


def stage(config: dict, mix: dict, xs: list, device) -> Staged:
    from ans_tpu_torch import models
    from ans_tpu_torch.parallel import BlockCodec
    from ans_tpu_torch.utils import stats

    method, lanes = config["method"], int(config["lanes"])
    sections, engine = int(mix.get("sections", 0)), mix.get("engine")
    kind, shards = mix["call"], bool(mix.get("shards"))
    if kind not in ("decode", "encode"):
        raise ValueError(f"unknown call {kind!r}")
    if shards and (kind != "decode" or not sections):
        raise ValueError("a sharded mix decodes a container of sections")
    if shards:
        from ans_tpu_torch.parallel.multihost import MultiHostBlockCodec
        sharded = MultiHostBlockCodec(method, sections, lanes, device=device)
        bc = sharded.codec
    else:
        bc = BlockCodec(method, sections, lanes, device=device) \
            if sections else None
    calls, blobs = [], []
    # a sharded mix's model half is read from the program's spans: in the
    # trace that is on already (portbench/spans.py), else in one of its own
    outer = stats._trace
    spans = (stats.tracing() if shards and outer is None
             else contextlib.nullcontext(outer))
    with stats.recording() as rec, spans as trace:
        first = len(trace.spans) if trace is not None else 0
        for x in xs:
            if kind == "encode":
                pe = (bc.prepare_encoder(x) if sections else
                      models.prepare_encoder(method, x, lanes=lanes,
                                             device=device))
                blob = pe.to_bytes(*pe())
                calls.append(pe)
                blobs.append(blob if sections else pe.prelude + blob)
            elif sections:
                blobs.append(sharded.encode_local(x) if shards
                             else bc.encode(x))
                calls.append(bc.prepare_decoder(blobs[-1],
                                                engine_name=engine))
            else:
                blobs.append(models.get(method, device=device,
                                        lanes=lanes).encode(x))
                calls.append(models.prepare_decoder(
                    method, blobs[-1], len(x), device=device, engine=engine))
    build_ns = rec.prelude_time_ns
    if shards:
        self_ns = trace.self_ns()
        build_ns = sum(self_ns[i] for i in range(first, len(trace.spans))
                       if trace.spans[i].name == "model.build")
    return Staged(kind, calls, blobs, sections, build_ns or None)


def join(address: str, world: int, rank: int) -> None:
    """Join the program's process group of `world` ranks at `address`."""
    from ans_tpu_torch.parallel import multihost
    multihost.initialize(address, world, rank)


def local_slice(n: int) -> tuple[int, int]:
    """[start, stop) of this rank's shard of an array of n values."""
    from ans_tpu_torch.parallel import multihost
    return multihost.local_block_slice(n)


def decoded_values(out: torch.Tensor, n: int, sections: int) -> torch.Tensor:
    """The n values (i32 bit patterns) of a decode's output: (T, S) for
    one stream, (D, T, S) for D sections of ceil(n / D) values."""
    if not sections:
        return out.reshape(-1)[:n]
    B = -(-n // sections)
    return out.reshape(sections, -1)[:, :B].reshape(-1)[:n]


def launch_counts() -> dict:
    """The program's launch counters: decode (K3, K4, K5), encode scan
    (K1, K6) and placement (K2)."""
    from ans_tpu_torch.ops import decode, encode, place
    return {"decode": (decode.launches + decode.direct_launches
                       + decode.grouped_launches),
            "encode": encode.launches + encode.grouped_launches,
            "place": place.launches}
