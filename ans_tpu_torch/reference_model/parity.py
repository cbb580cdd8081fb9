"""Byte-parity helpers of the compat engine's tests: a copy of
ans_tpu/reference_model/parity.py, held equal to it by
tests/test_torch_host.py (the byte coder's prelude is read by
reference_model/byte_model.py).

The reference's interp prelude writer leaves the unused high bits of its
final 32-bit word uninitialized (bits.hpp bit_stream flushes whatever
the accumulator holds); we zero them.  Everything else must match
byte-for-byte, so a comparison needs the byte span of that final word.
"""

from __future__ import annotations

from . import byte_model, model

# method tokens accepted below and by tools/ref_dump.cpp
METHODS = (["int", "msb"] + [f"fold{f}" for f in range(1, 9)]
           + [f"rfold{f}" for f in range(1, 5)]
           + [f"sint{h}" for h in (1, 80, 320)]
           + [f"smsb{h}" for h in (1, 80, 320)])


def prelude_padding_span(method: str, blob: bytes) -> tuple[int, int]:
    """Byte range [a, b) of the final interp-prelude word — the only
    place our bytes may legitimately differ from the reference's.
    rfold blobs open with a u32 reorder flag (+ the 2^(f+7)-entry map
    when set) before the shared prelude (ans_reorder_fold.hpp wire)."""
    off = 0
    if method.startswith("rfold"):
        fidelity = int(method[5:])
        flag = int.from_bytes(blob[0:4], "little")
        off = 4 + ((4 << (fidelity + 7)) if flag == 1 else 0)
    _, plen = model.load_prelude(blob[off:])
    return off + plen - 4, off + plen


def assert_byte_blob_parity(mine: bytes, ref: bytes) -> None:
    """ans_byte wire: the prelude is a raw interp block whose final
    word carries the reference's uninitialized padding bits — diffs are
    legitimate ONLY inside that word (anchored by parsing the prelude,
    not by the first diff, so a genuine stream divergence can't
    masquerade as padding)."""
    assert len(mine) == len(ref), f"byte: size {len(mine)} != {len(ref)}"
    diffs = [i for i in range(len(ref)) if mine[i] != ref[i]]
    if diffs:
        _, plen = byte_model.byte_prelude_decode(mine)
        bad = [d for d in diffs if not plen - 4 <= d < plen]
        assert not bad, (f"byte: non-padding mismatch at {bad[:5]} "
                         f"(padding span [{plen - 4},{plen}))")


def assert_blob_parity(method: str, mine: bytes, ref: bytes) -> None:
    """Raise AssertionError unless the two blobs are byte-identical
    outside the prelude-padding span."""
    assert len(mine) == len(ref), (
        f"{method}: size {len(mine)} != {len(ref)}")
    diffs = [i for i in range(len(ref)) if mine[i] != ref[i]]
    if diffs:
        a, b = prelude_padding_span(method, mine)
        bad = [d for d in diffs if not a <= d < b]
        assert not bad, (
            f"{method}: non-padding mismatch at {bad[:5]} "
            f"(padding span [{a},{b}))")
