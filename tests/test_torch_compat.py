"""The port's compat engine (models.get(name, engine="compat")) against the
C++ reference's own blobs and against ans_tpu's compat engine.

tests/fixtures/*.ref were written by the reference binary from the
committed .u32 inputs (tests/test_reference_parity.py holds ans_tpu to
them).  The port's coders must reproduce each blob byte for byte, outside
the reference's uninitialised prelude padding (the port's
parity.assert_blob_parity), and decode the reference's own bytes exactly.
On the conftest datasets the port's compat blobs equal ans_tpu's."""

import json
import pathlib

import numpy as np
import pytest

from ans_tpu import models as jmodels
from ans_tpu_torch import models
from ans_tpu_torch.reference_model import parity, rans_compat

FIX = pathlib.Path(__file__).parent / "fixtures"

# the reference dump's method tokens -> registry names
NAMES = {"int": "ANS", "msb": "ANSmsb", "sint80": "ANSsint-80",
         "smsb80": "ANSsmsb-80",
         **{f"fold{f}": f"ANSfold-{f}" for f in range(1, 9)},
         **{f"rfold{f}": f"ANSrfold-{f}" for f in range(1, 9)}}


def _cases():
    return sorted(json.loads((FIX / "sizes.json").read_text()))


def test_every_fixture_is_a_case():
    cases = _cases()
    assert len(cases) == len(list(FIX.glob("*.ref"))) == 40
    assert {c.split(".")[1] for c in cases} == {
        "byte", "shuff", "int", "msb", "sint80", "smsb80", "fold1", "fold2",
        "fold3", "fold4", "fold8", "rfold1", "rfold2", "rfold4"}


@pytest.mark.parametrize("case", _cases())
def test_reference_blob_parity(case):
    dname, method = case.split(".")
    data = np.fromfile(FIX / f"{dname}.u32", dtype="<u4")
    ref = (FIX / f"{dname}.{method}.ref").read_bytes()

    if method == "shuff":
        codec = models.get("shuff", engine="compat", device="cpu")
        # the shuff bitstream has no uninitialised padding: exact bytes
        assert bytes(codec.encode(data)) == ref, f"{case}: shuff wire"
        np.testing.assert_array_equal(codec.decode(ref, len(data)), data)
        return

    if method == "byte":
        codec = rans_compat.AnsByte()
        payload = (data & 0xFF).astype(np.uint8).tobytes()
        parity.assert_byte_blob_parity(bytes(codec.encode(payload)), ref)
        assert codec.decode(ref, len(payload)) == payload
        return

    codec = models.get(NAMES[method], engine="compat", device="cpu")
    parity.assert_blob_parity(method, codec.encode(data), ref)
    np.testing.assert_array_equal(codec.decode(ref, len(data)), data)


COMPAT_METHODS = ["ANS", "ANSmsb", "ANSfold-2", "ANSfold-7", "ANSrfold-2",
                  "ANSsint-80", "ANSsmsb-80", "shuff"]


@pytest.mark.parametrize("dataset", ["zipf12", "geometric", "uniform_small",
                                     "tiny", "single_sym"])
@pytest.mark.parametrize("method", COMPAT_METHODS)
def test_compat_blobs_equal_ans_tpu(datasets, dataset, method):
    x = datasets[dataset]
    codec = models.get(method, engine="compat", device="cpu")
    blob = bytes(codec.encode(x))
    assert blob == bytes(jmodels.get(method, "compat").encode(x))
    np.testing.assert_array_equal(codec.decode(blob, len(x)), x)


def test_compat_registry_names():
    """The compat engine names ans_tpu's compat ANS methods and shuff; the
    engine-independent methods of the port appear under both engines, and
    each engine names exactly ans_tpu's (the host codecs, which raised
    here until they were ported, among them)."""
    compat, lane = set(models.available("compat")), set(models.available())
    assert compat == lane
    ans_names = {n for n in jmodels._COMPAT}
    assert ans_names <= compat and ans_names <= lane
    for name in ("vbyte", "streamvbyte", "vbyteANS", "streamvbyteANS",
                 "pseudo_adaptive", "huffzero", "arith", "vbytefse"):
        assert name in compat and name in lane
        assert type(models.get(name, engine="compat", device="cpu")) is type(
            models.get(name, device="cpu"))
    assert set(jmodels.available("compat")) == compat
    assert set(jmodels.available("lane")) == lane
    assert type(models.get("shuff", device="cpu")).__name__ == "Shuff"
    assert type(models.get("shuff", engine="compat", device="cpu")
                ).__name__ == "ShuffCompat"
    with pytest.raises(KeyError, match="unknown engine"):
        models.get("ANS", engine="xla", device="cpu")
    assert isinstance(models.get("ANSfold-3", engine="compat", device="cpu"),
                      rans_compat.AnsFold)


@pytest.mark.parametrize("fidelity", [1, 2, 4])
def test_fold_values_past_2_30(fidelity):
    """Values at or above 2^30 through fold and msb: the reference's
    decoder mis-decodes them, ans_tpu (and its copy here) does not."""
    x = np.array([0, 1, 7, 1 << 30, (1 << 31) + 5, (1 << 32) - 1, 300, 1 << 30,
                  65536, 3] * 50, dtype=np.uint32)
    for name in (f"ANSfold-{fidelity}", "ANSmsb"):
        codec = models.get(name, engine="compat", device="cpu")
        blob = codec.encode(x)
        assert blob == jmodels.get(name, "compat").encode(x)
        np.testing.assert_array_equal(codec.decode(blob, len(x)), x)
