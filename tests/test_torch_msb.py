"""ANSmsb, ANSsmsb-h and ANSrfold-f on the CPU: ans_tpu_torch's codecs
write the same bytes as ans_tpu's, each decodes the other's blobs, the
prepared API reproduces encode(), and rfold's reorder header is held both
where the reorder is taken and where it is not."""

import numpy as np
import pytest

from ans_tpu.models.ans import AnsMsb as RefAnsMsb
from ans_tpu.models.ans import AnsReorderFold as RefAnsReorderFold
from ans_tpu.models.ans import AnsSmsb as RefAnsSmsb
from ans_tpu_torch import models
from ans_tpu_torch.models.ans import AnsMsb, AnsReorderFold
from ans_tpu_torch.ops import tables


def _ref(name, lanes):
    if name == "ANSmsb":
        return RefAnsMsb(lanes=lanes)
    kind, _, arg = name.partition("-")
    if kind == "ANSsmsb":
        return RefAnsSmsb(int(arg), lanes=lanes)
    return RefAnsReorderFold(int(arg), lanes=lanes)


def _check(name, x, lanes):
    """Blob equal to ans_tpu's, both decode both, and the prepared
    encoder's bytes; returns the blob and the port's decode table."""
    port = models.get(name, lanes=lanes, device="cpu")
    ref = _ref(name, lanes)
    blob = port.encode(x)
    ref_blob = ref.encode(x)
    assert blob == ref_blob
    np.testing.assert_array_equal(port.decode(ref_blob, len(x)), x)
    np.testing.assert_array_equal(ref.decode(blob, len(x)), x)
    pe = models.prepare_encoder(name, x, lanes=lanes or 4096, device="cpu")
    if lanes:
        assert pe.prelude + pe.to_bytes(*pe()) == blob
    pd = models.prepare_decoder(name, blob, len(x), device="cpu")
    np.testing.assert_array_equal(pd.to_host(pd()), x)
    return blob, port._dec_table(blob)[0]


@pytest.mark.parametrize("lanes", [None, 128])
@pytest.mark.parametrize("name", ["zipf12", "zipf_large", "wide",
                                  "geometric", "tiny", "single_sym"])
def test_msb_blob_identical_and_cross_decode(datasets, name, lanes):
    """ANSmsb: at most 1280 buckets, never the grouped layout."""
    _, table = _check("ANSmsb", datasets[name], lanes)
    assert isinstance(table, tables.SearchTable)


@pytest.mark.parametrize("name", ["zipf12", "wide"])
def test_smsb_blob_identical(datasets, name):
    """ANSsmsb-5: AnsMsb with its H_approx knob."""
    _check("ANSsmsb-5", datasets[name], 32)


@pytest.mark.parametrize("name,taken", [("zipf12", True),
                                        ("geometric", False),
                                        ("uniform_small", False),
                                        ("tiny", False)])
def test_rfold_reorder_taken_and_not(datasets, name, taken):
    """ANSrfold-2: the reorder is taken where 512 or more values are
    present (the u32 flag 1 and 512 raw values), not taken below (flag
    0); both decode branches."""
    x = datasets[name]
    blob, _ = _check("ANSrfold-2", x, 128)
    assert int.from_bytes(blob[:4], "little") == int(taken)
    assert taken == (len(np.unique(x)) >= 512)


def test_rfold_grouped_frame():
    """ANSrfold-6 on values below 2^15: the remapped alphabet has more
    than 2^13 live symbols, a grouped frame (K6 with its rank map, K5)."""
    x = np.random.default_rng(11).integers(0, 1 << 15, size=20000).astype(
        np.uint32)
    blob, table = _check("ANSrfold-6", x, 128)
    assert int.from_bytes(blob[:4], "little") == 1
    assert isinstance(table, tables.GroupedTable)


@pytest.mark.parametrize("fidelity", [1, 4, 8])
def test_rfold_fidelities(datasets, fidelity):
    _check(f"ANSrfold-{fidelity}", datasets["zipf12"], 64)


def test_msb_family_classes():
    """The registry builds AnsMsb for ANSmsb and ANSsmsb-h, AnsReorderFold
    for ANSrfold-f, each on an explicit device."""
    assert isinstance(models.get("ANSsmsb-80", device="cpu"), AnsMsb)
    assert isinstance(models.get("ANSrfold-3", device="cpu"),
                      AnsReorderFold)
    with pytest.raises(ValueError):
        AnsReorderFold(9, device="cpu")
    with pytest.raises(TypeError):
        models.get("ANSmsb")  # the device is never implicit
