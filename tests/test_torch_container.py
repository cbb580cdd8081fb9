"""The port's ATFC container and `python -m ans_tpu_torch` against
ans_tpu's: the same method, engine and input give the same file bytes,
each package reads the other's files, corrupt headers are rejected, and
the CLI round-trips (text input and the ATFB container of --blocked
too) on the CPU, which it uses only when asked."""

from pathlib import Path

import numpy as np
import pytest

from ans_tpu import container as jcontainer
from ans_tpu_torch import container, models
from ans_tpu_torch.__main__ import build_parser, main as cli

LANE_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "lane"


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return np.minimum(rng.zipf(1.3, size=20000) - 1, 1 << 20).astype(
        np.uint32)


CASES = [("ANSfold-2", "lane"), ("ANS", "lane"), ("ANSmsb", "lane"),
         ("vbyteANS", "lane"), ("pseudo_adaptive", "lane"),
         ("ANS", "compat"), ("ANSfold-2", "compat")]


@pytest.mark.parametrize("dataset", ["zipf12", "geometric"])
@pytest.mark.parametrize("method,engine", CASES)
def test_container_bytes_equal_ans_tpu(datasets, dataset, method, engine):
    """The same file as ans_tpu.container.compress; each package's
    decompress reads the other's file."""
    x = datasets[dataset]
    buf = container.compress(x, method, engine, device="cpu")
    assert buf == jcontainer.compress(x, method, engine)
    assert container.unpack(buf)[:3] == (method, engine, len(x))
    np.testing.assert_array_equal(container.decompress(buf, device="cpu"), x)
    np.testing.assert_array_equal(jcontainer.decompress(buf), x)


@pytest.mark.parametrize("method,engine", [("ANSfold-2", "lane"),
                                           ("ANSmsb", "compat"),
                                           ("shuff", "compat"),
                                           ("vbyte", "lane")])
def test_container_reads_ans_tpu_files(data, method, engine):
    buf = jcontainer.compress(data, method, engine)
    np.testing.assert_array_equal(container.decompress(buf, device="cpu"),
                                  data)
    assert container.compress(data, method, engine, device="cpu") == buf


def test_container_rejects_corruption(data):
    buf = bytearray(container.compress(data, "ANSfold-2", "compat",
                                       device="cpu"))
    with pytest.raises(ValueError, match="truncated ATFC header"):
        container.unpack(buf[:5])
    with pytest.raises(ValueError, match="not an ATFC container"):
        container.unpack(b"\x00" * 32)
    bad = bytearray(buf)
    bad[4] = 9  # version
    with pytest.raises(ValueError, match="unsupported ATFC version"):
        container.unpack(bad)
    bad = bytearray(buf)
    bad[5] = 2  # engine
    with pytest.raises(ValueError, match="corrupt ATFC header"):
        container.unpack(bad)
    with pytest.raises(ValueError, match="truncated ATFC"):
        container.unpack(buf[: len(buf) // 2])  # truncated payload
    with pytest.raises(ValueError, match="bad method name"):
        container.pack("", "lane", 1, b"")
    for corrupt in (buf[:5], b"\x00" * 32):
        with pytest.raises(ValueError):
            jcontainer.unpack(corrupt)


def test_entry_points_default_to_the_card():
    """The container and the CLI run on the GPU unless the CPU is asked
    for."""
    args = build_parser().parse_args(["compress", "a.u32", "b.atfc"])
    assert args.device == "cuda" and args.engine == "lane" and \
        args.method == "ANSfold-2" and args.devices == 1 and \
        args.lanes is None
    assert build_parser().parse_args(["decompress", "a", "b"]).device == \
        "cuda"
    assert container.compress.__kwdefaults__ == {"device": "cuda",
                                                 "lanes": None}
    assert container.decompress.__kwdefaults__ == {"device": "cuda"}


def test_cli_roundtrip(data, tmp_path, capsys):
    src = tmp_path / "in.u32"
    data.astype("<u4").tofile(src)
    atfc, dst = tmp_path / "out.atfc", tmp_path / "out.u32"
    assert cli(["compress", str(src), str(atfc), "-m", "ANSmsb",
                "--device", "cpu"]) == 0
    assert atfc.read_bytes() == jcontainer.compress(data, "ANSmsb", "lane")
    assert cli(["info", str(atfc)]) == 0
    out = capsys.readouterr().out
    assert "method=ANSmsb engine=lane n=20000" in out
    assert cli(["decompress", str(atfc), str(dst), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.fromfile(dst, dtype="<u4"), data)


def test_cli_compat_roundtrip(data, tmp_path):
    src = tmp_path / "in.u32"
    data.astype("<u4").tofile(src)
    atfc, dst = tmp_path / "out.atfc", tmp_path / "out.u32"
    assert cli(["compress", str(src), str(atfc), "-m", "ANSfold-2",
                "--engine", "compat", "--device", "cpu"]) == 0
    assert atfc.read_bytes() == jcontainer.compress(data, "ANSfold-2",
                                                    "compat")
    assert cli(["decompress", str(atfc), str(dst), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.fromfile(dst, dtype="<u4"), data)


def test_cli_text_input(tmp_path):
    src = tmp_path / "in.txt"
    src.write_text("5 1 2 3 4\n5 6\n")
    atfc, dst = tmp_path / "t.atfc", tmp_path / "t.u32"
    assert cli(["compress", "-t", str(src), str(atfc), "--device",
                "cpu"]) == 0
    assert cli(["decompress", str(atfc), str(dst), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(
        np.fromfile(dst, dtype="<u4"),
        np.array([5, 1, 2, 3, 4, 5, 6], dtype=np.uint32))


def test_cli_empty_input_exits(tmp_path):
    src = tmp_path / "empty.u32"
    src.write_bytes(b"")
    with pytest.raises(SystemExit, match="empty input"):
        cli(["compress", str(src), str(tmp_path / "e.atfc"), "--device",
             "cpu"])


def test_cli_blocked_equals_ans_tpu_container(tmp_path, capsys):
    """--blocked -D 2 on zipf20k writes ans_tpu's ATFB fixture (there D
    is the mesh size, here the section count); info and decompress
    recognise ATFB by its magic."""
    src = str(LANE_FIXTURES / "zipf20k.u32")
    atfb, dst = tmp_path / "out.atfb", tmp_path / "out.u32"
    assert cli(["compress", src, str(atfb), "--blocked", "-D", "2",
                "--device", "cpu"]) == 0
    assert atfb.read_bytes() == (
        LANE_FIXTURES / "zipf20k.fold2.d2.atfb").read_bytes()
    assert cli(["info", str(atfb)]) == 0
    out = capsys.readouterr().out
    assert "method=ANSfold-2 container=ATFB n=20000 D=2" in out
    assert cli(["decompress", str(atfb), str(dst), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.fromfile(dst, dtype="<u4"),
                                  np.fromfile(src, dtype="<u4"))


def test_cli_lanes(tmp_path):
    """-S sets the lanes of the stream (and of each --blocked section):
    the bytes of the codec built with that lane count."""
    x = np.fromfile(LANE_FIXTURES / "zipf20k.u32", dtype="<u4")
    src = str(LANE_FIXTURES / "zipf20k.u32")
    out = tmp_path / "s.atfc"
    assert cli(["compress", src, str(out), "-S", "128", "--device",
                "cpu"]) == 0
    _, _, n, blob = container.unpack(out.read_bytes())
    assert n == len(x) and blob == (
        LANE_FIXTURES / "zipf20k.fold2.s128.lane").read_bytes()
    from ans_tpu_torch.parallel import BlockCodec
    assert cli(["compress", src, str(out), "--blocked", "-D", "2", "-S",
                "128", "--device", "cpu"]) == 0
    assert out.read_bytes() == BlockCodec("ANSfold-2", 2, 128,
                                          device="cpu").encode(x)
    dst = tmp_path / "s.u32"
    assert cli(["decompress", str(out), str(dst), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.fromfile(dst, dtype="<u4"), x)


def test_cli_methods_lists_registry(capsys):
    assert cli(["methods"]) == 0
    assert capsys.readouterr().out.split() == models.available()


@pytest.mark.parametrize("method", ["huffzero", "arith", "shuff"])
def test_cli_unported_method_raises_the_roadmap_error(data, tmp_path,
                                                      method):
    """The host codecs that raised here until they were ported: the CLI
    writes ans_tpu's ATFC file of each and decompresses it exactly."""
    src, dst = tmp_path / "in.u32", tmp_path / "out.u32"
    data.astype("<u4").tofile(src)
    out = tmp_path / "x.atfc"
    assert cli(["compress", str(src), str(out), "-m", method,
                "--device", "cpu"]) == 0
    assert out.read_bytes() == jcontainer.compress(data, method, "lane")
    assert cli(["decompress", str(out), str(dst), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.fromfile(dst, dtype="<u4"), data)
