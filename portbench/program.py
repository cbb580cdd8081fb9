"""The system under test: ans_tpu_torch's prepared calls, staged for a cell.

The set-up stages one prepared call for each array of the configuration's
pool: for a decode mix it encodes the array once (the blob a user stores;
its model-half seconds come from the program's own `utils.stats` record)
and prepares a decoder of that blob; for an encode mix it prepares an
encoder of the array, whose first call writes the blob.  One stream
(`models.prepare_decoder` / `models.prepare_encoder`) or a blocked
container of `sections` sections (`parallel.BlockCodec`).  A request is
one call of the next staged object, on device-resident data.  The
benchmark reads the program's launch counters and nothing else of it.
"""

from __future__ import annotations

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
    kind = mix["call"]
    if kind not in ("decode", "encode"):
        raise ValueError(f"unknown call {kind!r}")
    bc = BlockCodec(method, sections, lanes, device=device) if sections \
        else None
    calls, blobs = [], []
    with stats.recording() as rec:
        for x in xs:
            if kind == "encode":
                pe = (bc.prepare_encoder(x) if sections else
                      models.prepare_encoder(method, x, lanes=lanes,
                                             device=device))
                blob = pe.to_bytes(*pe())
                calls.append(pe)
                blobs.append(blob if sections else pe.prelude + blob)
            elif sections:
                blobs.append(bc.encode(x))
                calls.append(bc.prepare_decoder(blobs[-1],
                                                engine_name=engine))
            else:
                blobs.append(models.get(method, device=device,
                                        lanes=lanes).encode(x))
                calls.append(models.prepare_decoder(
                    method, blobs[-1], len(x), device=device, engine=engine))
    return Staged(kind, calls, blobs, sections, rec.prelude_time_ns or None)


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
