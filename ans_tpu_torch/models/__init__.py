"""Codec registry of the port (counterpart of ans_tpu/models/__init__.py):
the same names under the same engines as ans_tpu's.

Every codec exposes `encode(values) -> bytes` and
`decode(buf, n) -> np.uint32 array`.  Two engines per ANS method:

  * "lane"   - the S-lane wire format, run on the device the codec was
               built for (the CUDA kernels, or their plain versions on
               the CPU)
  * "compat" - the C++ reference's own wire format, coded on the host
               (reference_model/rans_compat.py, in the host library)

The other names are the same under both engines: the byte path (vbyte,
streamvbyte and their ANS composites, run on the device; their fse and
huffzero composites split on the device and entropy-code on the host),
pseudo_adaptive (the ATFP block container, models/pseudo_adaptive.py),
and the host codecs (optpfor, arith, fse, huffzero, entropy_only),
which take the device argument and ignore it; `shuff` is the LUT codec
of models/shuff.py under the lane engine and the reference's canonical
Huffman wire (reference_model/shuff_compat.py) under compat.  The blocked
container is ans_tpu_torch.parallel.BlockCodec.
"""

from __future__ import annotations

from ..reference_model import rans_compat as _rc
from ..reference_model import shuff_compat as _shuff_compat
from . import ans as _lane
from . import arith as _arith
from . import bytes as _bytes
from . import config
from . import pfor as _pfor
from . import pseudo_adaptive as _pseudo
from . import shuff as _shuff
from . import tans as _tans
from .engine import PreparedDecoder, PreparedEncoder  # noqa: F401

# the H_approx values of ans_tpu's ANSsint-h and ANSsmsb-h names
H_VALUES = (1, 5, 10, 20, 40, 80, 160, 320)

# name -> codec factory (lanes, device)
_LANE = {
    "ANS": lambda lanes, device: _lane.AnsInt(lanes=lanes, device=device),
    **{f"ANSfold-{f}": (lambda lanes, device, f=f: _lane.AnsFold(
        f, lanes=lanes, device=device)) for f in range(1, 9)},
    **{f"ANSsint-{h}": (lambda lanes, device, h=h: _lane.AnsInt(
        h, lanes=lanes, device=device)) for h in H_VALUES},
    "ANSmsb": lambda lanes, device: _lane.AnsMsb(lanes=lanes, device=device),
    **{f"ANSsmsb-{h}": (lambda lanes, device, h=h: _lane.AnsMsb(
        h, lanes=lanes, device=device)) for h in H_VALUES},
    **{f"ANSrfold-{f}": (lambda lanes, device, f=f: _lane.AnsReorderFold(
        f, lanes=lanes, device=device)) for f in range(1, 9)},
}

# the reference's wire, coded on the host: name -> codec factory (lanes and
# device unused)
_COMPAT = {
    "ANS": lambda lanes, device: _rc.AnsInt(),
    "ANSmsb": lambda lanes, device: _rc.AnsMsb(),
    **{f"ANSfold-{f}": (lambda lanes, device, f=f: _rc.AnsFold(f))
       for f in range(1, 9)},
    **{f"ANSrfold-{f}": (lambda lanes, device, f=f: _rc.AnsReorderFold(f))
       for f in range(1, 9)},
    **{f"ANSsint-{h}": (lambda lanes, device, h=h: _rc.AnsSint(h))
       for h in H_VALUES},
    **{f"ANSsmsb-{h}": (lambda lanes, device, h=h: _rc.AnsSmsb(h))
       for h in H_VALUES},
}


# the byte path: splitters (no lanes) and split + AnsByte composites
_BYTE = {
    "vbyte": lambda lanes, device: _bytes.Vbyte(device=device),
    "streamvbyte": lambda lanes, device: _bytes.StreamVbyte(device=device),
    "vbyteANS": lambda lanes, device: _bytes.VbyteAns(lanes, device=device),
    "streamvbyteANS": lambda lanes, device: _bytes.StreamVbyteAns(
        lanes, device=device),
}

# block containers of per-block models: ans_tpu's default instance
_BLOCKS = {
    "pseudo_adaptive": lambda lanes, device: _pseudo.PseudoAdaptive(
        lanes=lanes, device=device),
}

# the host codecs and the host-entropy composites, whose split runs on
# `device`: name -> codec factory (lanes unused)
_HOST = {
    "optpfor": lambda lanes, device: _pfor.OptPFor(),
    "OptPFor": lambda lanes, device: _pfor.OptPFor(),
    "arith": lambda lanes, device: _arith.Arith(),
    "fse": lambda lanes, device: _tans.Fse(),
    "huffzero": lambda lanes, device: _bytes.HuffZero(),
    "huff0": lambda lanes, device: _bytes.HuffZero(),
    "vbytefse": lambda lanes, device: _bytes.VbyteFse(device=device),
    "streamvbytefse": lambda lanes, device: _bytes.StreamVbyteFse(
        device=device),
    "vbytehuffzero": lambda lanes, device: _bytes.VbyteHuffzero(
        device=device),
    "streamvbytehuffzero": lambda lanes, device: _bytes.StreamVbyteHuffzero(
        device=device),
    "entropy_only": lambda lanes, device: _bytes.EntropyOnly(),
    "entropy": lambda lanes, device: _bytes.EntropyOnly(),
}

# shuff: the lane engine's LUT codec, the reference's wire under compat
_SHUFF = {"lane": lambda lanes, device: _shuff.Shuff(),
          "compat": lambda lanes, device: _shuff_compat.ShuffCompat()}


def _registry(engine: str) -> dict:
    ans = {"lane": _LANE, "compat": _COMPAT}
    if engine not in ans:
        raise KeyError(f"unknown engine {engine!r}; known: {sorted(ans)}")
    return {**ans[engine], "shuff": _SHUFF[engine], **_BYTE, **_BLOCKS,
            **_HOST}


def _lookup(name: str, registry=None, engine: str = "lane"):
    """The factory of `name` in `registry` (default: the engine's whole
    registry); a known name outside a given registry is not a lane-format
    ANS method."""
    known = _registry(engine)
    registry = known if registry is None else registry
    if name in registry:
        return registry[name]
    if name in known:
        raise KeyError(f"{name!r} is not a lane-format ANS method")
    raise KeyError(f"unknown method {name!r}; known: {sorted(known)}")


def available(engine: str = "lane"):
    return sorted(_registry(engine))


def get(name: str, *, device, lanes: int | None = None,
        engine: str = "lane"):
    """The codec `name` under `engine` ("lane" or "compat"); a lane codec
    runs on `device` (e.g. "cuda" or "cpu") and writes `lanes` lanes
    (None: the default lane count of the input)."""
    return _lookup(name, engine=engine)(lanes, device)


def prepare_decoder(name: str, blob: bytes, n: int, *, device,
                    engine: str | None = None):
    """Stage a lane-format blob for repeated decodes on `device`: parse
    the wire prelude, rebuild the decode table as `decode()` does, and
    return an engine.PreparedDecoder (call it to run the kernel).
    `engine` forces "search", "grouped" or "direct" (ValueError when the
    frame is not eligible for it); None leaves the choice to
    engine.choose_decode_engine."""
    codec = _lookup(name, _LANE)(None, device)
    return codec.prepare_decoder(memoryview(blob).tobytes(), n, engine)


def prepare_encoder(name: str, values, *, lanes: int = 4096, device):
    """Stage device-resident encode for repeated runs on `device`: model
    build and mapping (the codec's _enc_inputs half), tables, (T, S) lane
    staging and the section plan, returned as an engine.PreparedEncoder.
    `pe.prelude + pe.to_bytes(*pe())` is the full wire blob, identical to
    `get(name, device=device).encode(values)` for a codec with the same
    lane count."""
    codec = _lookup(name, _LANE)(lanes, device)
    mapped, k, low, pfreqs, ffreqs, raw, header = codec._enc_inputs(values)
    n = int(mapped.shape[0])
    S = config.validate_lanes(lanes) or config.default_lane_count(n)
    table, staged = _lane._stage(mapped, k, low, n, ffreqs, raw, S)
    pe = PreparedEncoder(*staged, n, table)
    pe.prelude = header + codec._prelude(pfreqs)
    return pe
