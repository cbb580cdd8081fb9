"""Codec registry of the port (counterpart of ans_tpu/models/__init__.py).

Every codec exposes `encode(values) -> bytes` and
`decode(buf, n) -> np.uint32 array` and runs on the device it was built
for.  Only the lane-engine ANSfold methods are ported so far; any other
name of ans_tpu's registry raises KeyError naming the ROADMAP item that
will port it.
"""

from __future__ import annotations

from ans_tpu.reference_model.model import serialize_prelude

from ..ops import lane_codec
from . import ans as _lane
from . import config, framing
from .engine import PreparedDecoder, PreparedEncoder

# name -> codec factory (lanes, device)
_LANE = {
    "ANS": lambda lanes, device: _lane.AnsInt(lanes=lanes, device=device),
    **{f"ANSfold-{f}": (lambda lanes, device, f=f: _lane.AnsFold(
        f, lanes=lanes, device=device)) for f in range(1, 9)},
    **{f"ANSsint-{h}": (lambda lanes, device, h=h: _lane.AnsInt(
        h, lanes=lanes, device=device))
       for h in (1, 5, 10, 20, 40, 80, 160, 320)},
}

# name prefix -> where it is queued (ROADMAP.md, queue 1)
_UNPORTED = (
    ("ANSrfold-", "queue 1 item 4 (AnsReorderFold)"),
    ("ANSsmsb-", "queue 1 item 4 (AnsSmsb)"),
    ("ANSmsb", "queue 1 item 4 (AnsMsb)"),
    ("pseudo_adaptive", "queue 1 item 9 (pseudo-adaptive)"),
    ("", "queue 1 item 8 (byte splitters and host codecs)"),
)


def _lookup(name: str):
    if name in _LANE:
        return _LANE[name]
    todo = next(item for prefix, item in _UNPORTED if name.startswith(prefix))
    raise KeyError(f"method {name!r} is not ported to ans_tpu_torch yet "
                   f"(ROADMAP {todo}); ported: {available()}")


def available():
    return sorted(_LANE)


def get(name: str, *, device, lanes: int | None = None):
    """The codec `name` running on `device` (e.g. "cuda" or "cpu"),
    writing `lanes` lanes (None: the default lane count of the input)."""
    return _lookup(name)(lanes, device)


def prepare_decoder(name: str, blob: bytes, n: int, *, device):
    """Stage a lane-format blob for repeated decodes on `device`: parse
    the wire prelude, rebuild the decode table as `decode()` does, and
    return an engine.PreparedDecoder (call it to run the kernel)."""
    codec = _lookup(name)(None, device)
    blob = memoryview(blob).tobytes()
    table, off = codec._dec_table(blob)
    S, states, payload, _, sec_len = framing.parse(blob, off)
    T = lane_codec.lane_steps(n, S)
    return PreparedDecoder(payload, states, table, n, S=S, T=T,
                           sec_len=sec_len, device=device)


def prepare_encoder(name: str, values, *, lanes: int = 4096, device):
    """Stage device-resident encode for repeated runs on `device`: model
    build and mapping (the codec's _enc_inputs half), tables, (T, S) lane
    staging and the section plan, returned as an engine.PreparedEncoder.
    `pe.prelude + pe.to_bytes(*pe())` is the full wire blob, identical to
    `get(name, device=device).encode(values)` for a codec with the same
    lane count."""
    codec = _lookup(name)(lanes, device)
    mapped, k, low, pfreqs, ffreqs, raw = codec._enc_inputs(values)
    n = int(mapped.shape[0])
    S = config.validate_lanes(lanes) or config.default_lane_count(n)
    table, staged = _lane._stage(mapped, k, low, n, ffreqs, raw, S)
    pe = PreparedEncoder(*staged, n, table)
    pe.prelude = serialize_prelude(pfreqs, int(pfreqs.sum()))
    return pe
