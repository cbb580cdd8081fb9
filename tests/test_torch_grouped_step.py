"""The short group search of K5 (csrc/decode_grouped.cu) and the choice of
its instance, on the CPU.

K5 finds a slot's group by one bucket load and a few probes
(ops/tables.py `bucket_table`); its plain version keeps the full search,
and the kernel must return the same group for every slot.  Here the
kernel's search, written out in tensor ops (lane_codec.bucket_search), is
held against the plain version's `searchsorted` and against numpy's search
over the group boundaries ans_tpu's own layout gives, for every slot of the
frame.  The wrapper's checks that need no card (the instance, the ring's
fit, the stream's length) run on tensors of the "meta" device."""

import numpy as np
import pytest
import torch

from ans_tpu.ops import grouped as jgrouped
from ans_tpu_torch import bench_steps
from ans_tpu_torch.csrc import build
from ans_tpu_torch.ops import decode, lane_codec, tables


def _zipf_frame(sigma, log2m, seed):
    """sigma live symbols in no order, Zipf(1) frequencies summing to
    2^log2m."""
    M = 1 << log2m
    w = 1.0 / np.arange(1, sigma + 1)
    nf = 1 + np.floor((M - sigma) * w / w.sum()).astype(np.int64)
    nf[0] += M - int(nf.sum())
    return np.random.default_rng(seed).permutation(nf).astype(np.uint64)


def _most_groups(log2m=22):
    """Frequencies 1..k, all distinct, summing to 2^log2m: as many groups
    as a frame can have (2895 at M = 2^22; sqrt(2M) = 2896.3)."""
    M = 1 << log2m
    k = int(((8 * M + 1) ** 0.5 - 1) / 2)
    f = np.arange(1, k + 1)
    f[k - 1] += M - int(f.sum())
    return np.random.default_rng(3).permutation(f).astype(np.uint64)


def _one_bucket(log2m=17):
    """One symbol owns all but the last 120 slots, and fifteen groups
    (f = 15 .. 1) share the last bucket of 128: every boundary but the
    first lies in one bucket."""
    f = np.concatenate([[(1 << log2m) - 120], np.arange(15, 0, -1)])
    pad = np.zeros(9000, np.int64)  # absent symbols
    return np.concatenate([f, pad]).astype(np.uint64)


FRAMES = {
    "zipf": lambda: _zipf_frame(9000, 15, 1),
    "grouped_path": lambda: _zipf_frame(20416, 17, 2),
    "dense": lambda: _zipf_frame(1 << 16, 19, 3),
    "one_group": lambda: np.ones(1 << 14, np.uint64),
    "two_slots": lambda: np.array([1, 1], np.uint64),
    "most_groups": _most_groups,
    "one_bucket": _one_bucket,
}


@pytest.fixture(scope="module", params=sorted(FRAMES))
def frame(request):
    nf = FRAMES[request.param]()
    return request.param, nf, tables.to_device(
        tables.build_grouped_table(nf), "cpu")


def test_bucket_search_finds_the_group_of_every_slot(frame):
    name, nf, t = frame
    M = t.frame_size
    slot = torch.arange(M, dtype=torch.int64)
    want = torch.searchsorted(t.bases[:-1].to(torch.int64), slot,
                              right=True) - 1
    got = lane_codec.bucket_search(t, slot)
    assert torch.equal(got, want)
    lay = jgrouped.build_group_layout(nf)
    np.testing.assert_array_equal(
        got.numpy(), np.searchsorted(lay.g_slot0.astype(np.int64),
                                     np.arange(M), side="right") - 1)
    assert int(got.max()) == lay.num_groups - 1


def test_bucket_table_shape(frame):
    """At most 1024 u16 buckets of 2^shift slots, and no more levels than
    the bucket that spans most groups needs."""
    name, nf, t = frame
    M, NG = t.frame_size, t.groups.shape[0]
    assert t.buckets.dtype == torch.int16
    assert t.buckets.numel() == ((M - 1) >> t.shift) + 1 <= tables.MAX_BUCKETS
    assert t.buckets.numel() == min(M, tables.MAX_BUCKETS)
    first = t.buckets.numpy().view(np.uint16).astype(np.int64)
    slot0 = t.groups[:, 2].numpy().astype(np.int64)
    ends = np.minimum((np.arange(len(first)) + 1) << t.shift, M) - 1
    last = np.searchsorted(slot0, ends, side="right") - 1
    span = int((last - first).max())
    assert span < 1 << t.levels
    assert t.levels == 0 or span >= 1 << (t.levels - 1)
    assert t.levels <= t.depth
    want = {"one_group": 0, "two_slots": 0, "one_bucket": 4}.get(name)
    assert want is None or t.levels == want
    if name == "most_groups":
        assert NG == 2895 and t.depth == 12 and t.levels < t.depth
    if name == "one_bucket":
        assert NG == 16 and (first[:-1] == 0).all()


def _meta(n, dtype):
    return torch.empty(n, dtype=dtype, device="meta")


def _with_exceptions(nf):
    ids = np.arange(len(nf), dtype=np.uint32)
    return tables.to_device(tables.build_grouped_table(
        nf, ids << np.uint32(8), np.ones(len(nf), np.uint32)), "cpu")


@pytest.mark.parametrize("name,S,want_table,want", [
    # ANSfold-7 on 2^20-value data: 108 KB of tables and a 64 KB ring
    ("grouped_path", 4096, True, ("ring", 65536)),
    # a 256 KB value table stays in global memory; the ring fits
    ("dense", 4096, False, ("ring", 32768)),
    # 201 KB of tables fit the block, the 64 KB ring beside them does not
    ("table_fills", 4096, True, ("global", 0)),
    ("grouped_path", 32, True, ("ring", 1024)),
    # four rounds of 16384 lanes: a 256 KB ring fits no block
    ("grouped_path", 16384, True, ("global", 0)),
])
def test_choose_instance_for_grouped_frames(name, S, want_table, want):
    if name == "dense":
        t = tables.to_device(tables.build_grouped_table(FRAMES[name]()),
                             "cpu")
    elif name == "table_fills":
        t = _with_exceptions(_zipf_frame(40000, 17, 4))
    else:
        t = _with_exceptions(FRAMES[name]())
    in_shared, smem = decode.grouped_shared_tables(t)
    assert in_shared == want_table
    assert smem == t.group_bytes() + (t.rank_table_bytes() if in_shared
                                      else 0)
    assert smem <= tables.DIRECT_TABLE_BYTES
    assert t.rank_table_bytes() == 4 * t.table.numel() + t.nb.numel()
    assert decode.choose_instance("decode_grouped", smem, S,
                                  t.NR + t.NE) == want


def test_wrapper_refuses_before_it_needs_a_card():
    """A ring forced where it cannot fit, an unknown instance and a stream
    of 2^31 bytes raise from the checks that need no card; nothing is
    launched."""
    t = _with_exceptions(_zipf_frame(40000, 17, 4))
    states = _meta(4096, torch.int32)
    before = (decode.grouped_launches,
              dict(decode.instance_launches["decode_grouped"]))
    with pytest.raises(ValueError, match="does not fit"):
        decode.decode_grouped(_meta(100, torch.uint8), states, t, 4096, 1,
                              instance="ring")
    with pytest.raises(ValueError, match="unknown instance"):
        decode.decode_grouped(_meta(100, torch.uint8), states, t, 4096, 1,
                              instance="smem")
    with pytest.raises(NotImplementedError, match="2147483648 bytes"):
        decode.decode_grouped(_meta(1 << 31, torch.uint8), states, t, 4096,
                              1)
    with pytest.raises(NotImplementedError, match="lanes"):
        decode.decode_grouped(_meta(100, torch.uint8),
                              _meta(1 << 15, torch.int32), t, 1 << 15, 1)
    # the largest stream the kernel takes passes these checks and then
    # needs the card
    with pytest.raises(ValueError, match="tensors on|no kernel"):
        decode.decode_grouped(_meta((1 << 31) - 1, torch.uint8), states, t,
                              4096, 1)
    assert before == (decode.grouped_launches,
                      decode.instance_launches["decode_grouped"])


def test_cpu_tensors_take_the_plain_version_whatever_the_instance():
    """On CPU tensors there is no instance to choose: `instance` is not
    read, and no launch is counted."""
    nf = FRAMES["zipf"]()
    t = tables.to_device(tables.build_grouped_table(nf), "cpu")
    enc = tables.grouped_enc_to_device(
        jgrouped.build_group_layout(nf), "cpu", rank_of=False)
    n, S = 700, 32
    T = lane_codec.lane_steps(n, S)
    rng = np.random.default_rng(0)
    ranks = np.zeros(T * S, np.int32)
    ranks[:n] = rng.integers(0, t.sigma, size=n)
    syms = torch.from_numpy(ranks.reshape(T, S))
    packed, states = lane_codec.encode_scan_grouped_plain(syms, n, enc)
    zero = torch.zeros_like(packed)
    stream, _, _ = lane_codec.place_plain(packed, zero, zero, n)
    before = decode.grouped_launches
    outs = [decode.decode_grouped(stream, states, t, n, T, instance=i)
            for i in (None, "ring", "global")]
    assert decode.grouped_launches == before
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    perm = jgrouped.build_group_layout(nf).perm.astype(np.int64)
    np.testing.assert_array_equal(
        outs[0].reshape(-1)[:n].numpy(), perm[ranks[:n]])


def test_bench_steps_substitutions_match_the_sources():
    """bench_steps rebuilds the kernels' earlier forms by replacing text in
    a copy of csrc/: every text it replaces stands in the sources exactly
    once, so the script times what it says it times."""
    patches = [bench_steps.LANE_AFTER_LANE, bench_steps.SCALAR_STORES,
               bench_steps.REGISTER_ROWS, *bench_steps.REGISTER_LAUNCH,
               *bench_steps.FOUR_LOOKUP_WARPS, bench_steps.chain_warps(2),
               bench_steps.NO_LOOKUPS, bench_steps.NO_CHAIN,
               bench_steps.BYTE_STORES, *bench_steps.FOUR_LANES_A_THREAD,
               bench_steps.NARROW_LOOK_BACK, bench_steps.WIDE_LOOK_BACK,
               bench_steps.NO_LOOK_BACK,
               bench_steps.TWO_STEPS_A_CHUNK, bench_steps.BLOCK_INDEX,
               bench_steps.RELAXED_PUBLISH, *bench_steps.TIMELINE,
               bench_steps.STAGE_UNROLLED, bench_steps.PAUSE,
               *bench_steps.LOOK_BACK_FIRST]
    for fname, old, new in patches:
        assert (build.CSRC / fname).read_text().count(old) == 1, (fname, old)
        assert new != old


BYTE_PATCHES = [
    *bench_steps.byte_threads("bytesplit_encode.cu", 64),
    *bench_steps.byte_threads("vbyte_decode.cu", 512),
    bench_steps.uncapped("bytesplit_encode.cu"),
    bench_steps.uncapped("vbyte_decode.cu"),
    bench_steps.NARROW_BYTE_LOOK_BACK, bench_steps.WIDE_BYTE_LOOK_BACK,
    bench_steps.NO_BYTE_LOOK_BACK, bench_steps.K7_BRANCHED_LOADS,
    bench_steps.K7_SCALAR_LOADS, bench_steps.K7_READ_AGAIN,
    bench_steps.K7_BYTE_STORES, *bench_steps.K7_LOOK_BACK_FIRST,
    *bench_steps.K7_SCATTERED, *bench_steps.K7_TIMELINE,
    bench_steps.K9_BRANCHED_LOADS, bench_steps.K9_GLOBAL_WALK,
    bench_steps.K9_SCALAR_LOADS, *bench_steps.K9_BY_ELEMENT,
    bench_steps.K9_WORD_STORES, *bench_steps.K9_LOOK_BACK_FIRST,
    *bench_steps.K9_TIMELINE,
    *bench_steps.byte_threads("svb_decode.cu", 128),
    bench_steps.uncapped("svb_decode.cu"), bench_steps.k8_look(2),
    bench_steps.K8_FIVE_BLOCKS,
    *bench_steps.K8_GATHER,
    bench_steps.K8_WORD_STORES, *bench_steps.K8_TWO_LAUNCHES,
    *bench_steps.K8_TIMELINE]


@pytest.mark.parametrize("patch", BYTE_PATCHES,
                         ids=[f"{p[0]}-{i}" for i, p in enumerate(
                             BYTE_PATCHES)])
def test_bench_steps_byte_substitutions_match_the_sources(patch):
    """The same for K7, K8 and K9's design steps: each text stands in its
    source exactly once."""
    fname, old, new = patch
    assert (build.CSRC / fname).read_text().count(old) == 1, (fname, old)
    assert new != old


@pytest.mark.parametrize("name", ["bytesplit_encode", "svb_decode",
                                  "vbyte_decode"])
def test_bench_steps_earlier_byte_sources_stand_beside_the_kernels(name):
    """The earlier K7, K8 and K9 (three launches over bytescan.cuh) are
    kept whole with that header in earlier_csrc/, export the C entry points
    they had, and no codec path builds them: the kernels are single passes
    on lookback.cuh, and no source in csrc/ includes bytescan.cuh, which
    lives only beside the earlier forms."""
    text = (bench_steps.EARLIER / f"{name}.cu").read_text()
    assert f'extern "C" int {name}(' in text
    assert '#include "bytescan.cuh"' in text
    assert "scan_totals_kernel<<<1, 1024" in text
    assert "lookback.cuh" not in text
    assert "lookback.cuh" in (build.CSRC / f"{name}.cu").read_text()
    assert "scan_totals_kernel" in (
        bench_steps.EARLIER / "bytescan.cuh").read_text()
    assert not (build.CSRC / "bytescan.cuh").exists()
    for src in build.CSRC.glob("*.cu*"):
        assert "bytescan.cuh" not in src.read_text(), src.name


def test_bench_steps_earlier_sources_stand_beside_the_kernels():
    """The earlier forms of K1 and K2 that bench_steps copies over its copy
    of csrc/ export the C entry points the kernels had, and no codec path
    builds them (build.py reads csrc/ alone)."""
    for name in ("encode_scan", "place"):
        text = (bench_steps.EARLIER / f"{name}.cu").read_text()
        assert f'extern "C" int {name}(' in text
        assert '#include "common.cuh"' in text
        assert bench_steps.EARLIER != build.CSRC
    assert "round_base" in (bench_steps.EARLIER / "place.cu").read_text()
    assert '#include "encode_ahead.cuh"' not in (
        bench_steps.EARLIER / "encode_scan.cu").read_text()
