"""The step probe's plain chains (ans_tpu_torch/probe.py) against numpy
loops of the same recurrences, exactly, at a small depth.

The other side cannot be tools/mosaic_probe.py, the TPU tool the probe
replaces: it needs a TPU (`pltpu.roll`, `pltpu.bitcast`, VMEM block specs
have no CPU form), it fixes ITERS at 4000, and its list of ops is the
TPU's.  So each plain chain is held against an independent numpy loop,
thread by thread, and the kernel against the plain chain on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from ans_tpu_torch import probe
from ans_tpu_torch.ops import decode

ITERS = 2
M32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def inp():
    return probe.make_inputs("cpu", 1 << 16)


def _u32(t):
    return t.numpy().view(np.uint32).astype(object)


def _numpy_scalar(name, x, inp, steps):
    """One python-int loop per step; warps are groups of 32 threads."""
    c = probe.CHAINS[name]
    tab, rows = _u32(inp.tab), _u32(inp.rows)
    slot = inp.slot_sym.numpy().view(np.uint16).astype(int)
    buf = inp.buf.tolist()
    v = [int(a) for a in _u32(x)]
    for _ in range(steps):
        if name == "add":
            v = [(a + c.p0) & M32 for a in v]
        elif name == "cmp_select":
            v = [a - c.p0 if a >= c.p0 else (a + c.p1) & M32 for a in v]
        elif name == "shift_or":
            v = [(a >> 1) | c.p0 for a in v]
        elif name == "umulhi":
            v = [(((a * c.p0) >> 32) + c.p1) & M32 for a in v]
        elif name == "shfl_up":
            v = [((v[i] if i % 32 == 0 else v[i - 1]) + 1) & M32
                 for i in range(len(v))]
        elif name == "ballot_popc":
            v = [(v[i] + sum(v[j] & 1 for j in range(i - i % 32, i))) & M32
                 for i in range(len(v))]
        elif name == "smem_load":
            v = [int(tab[a & 4095]) for a in v]
        elif name == "lookup2":
            out = []
            for a in v:
                s = a & ((1 << inp.log2m) - 1)
                e = rows[slot[s]]
                out.append((int(e[0]) * (a >> inp.log2m) + s - int(e[1])
                            + int(e[2])) & M32)
            v = out
        elif name == "syncthreads":
            v = [(a + 1) & M32 for a in v]
        elif name == "redux_add":
            v = [(v[i] + sum(v[j] & 3 for j in range(i - i % 32,
                                                     i - i % 32 + 32))) & M32
                 for i in range(len(v))]
        else:  # gload_*
            v = [((a + buf[a & (len(buf) - 1)]) * probe.GOLD + 12345) & M32
                 for a in v]
    return np.array(v, dtype=np.uint64).astype(np.uint32)


def _numpy_scan(x, steps):
    v = [int(a) for a in _u32(x)]
    for _ in range(steps):
        cnt = [[(a >> (2 * r)) & 3 for r in range(6)] for a in v]
        tot = [sum(c[r] for c in cnt) for r in range(6)]
        out = []
        for i, a in enumerate(v):
            s = sum(tot)
            for r in range(6):
                s += sum(tot[:r]) + sum(cnt[j][r] for j in range(i))
            out.append((a * 1664525 + 1 + s) & M32)
        v = out
    return np.array(v, dtype=np.uint64).astype(np.uint32)


def _numpy_read(x, buf, steps):
    """Lane after lane, round after round, one byte cursor."""
    v = [int(a) for a in _u32(x)]
    buf = buf.numpy()
    cursor = 0
    for _ in range(steps):
        rc = [a & 3 for a in v]
        ne = [(a >> 2) & 3 for a in v]
        st, lo = list(v), [0] * len(v)
        for j in range(6):
            for i in range(len(v)):
                if (rc[i] > j) if j < 3 else (ne[i] > j - 3):
                    b = int(buf[cursor]) if cursor < len(buf) else 0
                    cursor += 1
                    if j < 3:
                        st[i] = ((st[i] << 8) | b) & M32
                    else:
                        lo[i] = (lo[i] << 8) | b
        v = [((s ^ l) * probe.GOLD + 1) & M32 for s, l in zip(st, lo)]
    return np.array(v, dtype=np.uint64).astype(np.uint32)


def _numpy_encode(x, inp, steps):
    """Thread after thread, lane::encode_step as the kernel writes it: the
    divide by the Granlund-Montgomery multiply-high, not by `//`."""
    rows = _u32(inp.enc_rows)
    log2m = inp.grouped.log2m
    A_L = 1 << 23
    out = []
    for k, a in enumerate(_u32(x)):
        st, words = A_L | (int(a) & (A_L - 1)), 0
        for i in range(steps):
            f, base, magic, _ = (int(w) for w in rows[
                (k + i * len(x)) & (probe.ENC_ROWS - 1)])
            ub = (f << (31 - log2m)) & M32
            word = rc = 0
            for j in range(3):
                word |= (st & 0xFF) << (8 * j)
                if st >= ub:
                    st >>= 8
                    rc += 1
            if f == 1:
                q = st
            else:
                mh = (st * magic) >> 32
                q = (mh + ((st - mh) >> 1)) >> ((f - 1).bit_length() - 1)
            assert q == st // f
            st = ((q << log2m) + (st - q * f) + base) & M32
            assert A_L <= st < 1 << 31
            words = (words + (word | rc << 24)) & M32
        out.append((st + words) & M32)
    return np.array(out, dtype=np.uint64).astype(np.uint32)


def _numpy_group(x, inp, steps):
    """K5's lookup with the group found by numpy's own search over the
    groups' first slots."""
    g = inp.grouped
    rows = _u32(g.groups)
    slot0 = g.groups[:, 2].numpy().astype(np.int64)
    table = _u32(g.table)
    v = [int(a) for a in _u32(x)]
    for _ in range(steps):
        out = []
        for a in v:
            slot = a & (g.frame_size - 1)
            f, _, lb, rank0 = (int(w) for w in rows[
                np.searchsorted(slot0, slot, side="right") - 1])
            j = (slot - lb) // f
            s0 = (f * (a >> g.log2m) + slot - lb - j * f) & M32
            out.append(((s0 ^ int(table[rank0 + j])) * probe.GOLD + 1) & M32)
        v = out
    return np.array(v, dtype=np.uint64).astype(np.uint32)


def test_probe_frames_are_what_the_chains_are_named_for(inp):
    """The grouped frame has a value table, several search levels and
    fewer of them than the full search; the encode rows are valid rows of
    its frame."""
    g = inp.grouped
    assert g.table.numel() == g.sigma == probe.G_SIGMA and g.NE == 0
    assert 0 < g.levels < g.depth and g.groups.shape[0] > 100
    f = inp.enc_rows[:, 0]
    assert int(f.min()) >= 1 and int(f.max()) > 1
    assert int((inp.enc_rows[:, 1] + f).max()) <= g.frame_size


@pytest.mark.parametrize("threads", [32, 96])
@pytest.mark.parametrize("name", sorted(probe.CHAINS))
def test_plain_chain_equals_numpy_loop(inp, name, threads):
    kind = probe.CHAINS[name].kind
    x = probe.make_x(name, threads, "cpu", seed=threads)
    steps = ITERS * probe.UNROLL
    got = probe.run_plain(name, x, ITERS, inp).numpy().view(np.uint32)
    if kind == "scalar":
        want = _numpy_scalar(name, x, inp, steps)
    elif kind == "scan":
        want = _numpy_scan(x, steps)
    elif kind == "encode":
        want = _numpy_encode(x, inp, steps)
    elif kind == "group":
        want = _numpy_group(x, inp, steps)
    else:
        want = _numpy_read(x, inp.buf, steps)
    np.testing.assert_array_equal(got, want)
    # on a CPU tensor the wrapper takes the plain chain
    assert torch.equal(probe.run(name, x, ITERS, inp),
                       probe.run_plain(name, x, ITERS, inp))


def test_old_and_new_step_chains_share_their_values(inp):
    """The old and the new scan, and the three byte reads, compute one
    function each: their plain chains are the same recurrence."""
    x = probe.make_x("scan_old", 64, "cpu")
    assert torch.equal(probe.run_plain("scan_old", x, ITERS, inp),
                       probe.run_plain("scan_new", x, ITERS, inp))
    x = probe.make_x("read_old", 32, "cpu")
    want = probe.run_plain("read_old", x, ITERS, inp)
    for name in ("read_global", "read_ring"):
        assert torch.equal(probe.run_plain(name, x, ITERS, inp), want)
    assert probe.make_x("read_ring", 1024, "cpu").numel() == 4096


def test_read_chain_past_the_end_reads_zero(inp):
    """A stream shorter than what the lanes ask for: the plain read takes
    zeros past its end, as the decoders' plain versions do."""
    short = dataclasses.replace(inp, buf=inp.buf[:16].clone())
    x = probe.make_x("read_ring", 32, "cpu")
    v, cursor = probe._read_op(x.to(torch.int64) & M32, 0, short.buf)
    assert cursor > 16
    want = _numpy_read(x, short.buf, 1)
    np.testing.assert_array_equal(v.numpy().astype(np.uint32), want)


def test_kernel_wrapper_refuses_cpu_tensors(inp):
    """Asked for the kernel, a CPU tensor raises; nothing falls back."""
    x = probe.make_x("add", 32, "cpu")
    count = probe.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        probe.run_kernel("add", x, ITERS, inp)
    assert probe.launches == count


@pytest.mark.parametrize("bad", ["name", "dtype", "threads", "buf", "depth",
                                 "enc_rows", "grouped"])
def test_wrapper_checks_its_arguments(inp, bad):
    x = probe.make_x("read_ring", 32, "cpu")
    args = {"name": ("nope", x, ITERS, inp),
            "dtype": ("add", x.to(torch.int64), ITERS, inp),
            "threads": ("add", x[:20], ITERS, inp),
            "buf": ("add", x, ITERS, dataclasses.replace(
                inp, buf=inp.buf[:1000])),
            "depth": ("read_ring", x, 1 << 12, inp),
            "enc_rows": ("encode_step", x, ITERS, dataclasses.replace(
                inp, enc_rows=inp.enc_rows[:100])),
            # a frame with exception bytes is not what group_search reads
            "grouped": ("group_search", x, ITERS, dataclasses.replace(
                inp, grouped=dataclasses.replace(inp.grouped, NE=1)))}[bad]
    with pytest.raises(ValueError):
        probe.run_plain(*args)


def test_cli_on_the_cpu_prints_every_chain(capsys):
    assert probe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in probe.CHAINS:
        assert f"plain {name}" in out


@pytest.mark.parametrize("S,rounds,want", [
    (1, 2, 1024), (32, 5, 1024), (4096, 2, 32768), (4096, 5, 65536),
    (4096, 4, 65536), (4096, 6, 65536), (16384, 2, 131072),
    (16384, 6, 262144)])
def test_ring_holds_two_steps_and_a_granule(S, rounds, want):
    """The ring is a power of two of at least two steps' worst case plus
    one 16-byte granule (csrc/lockstep.cuh rests on that)."""
    ring = decode.ring_bytes(S, rounds)
    assert ring == want and ring & (ring - 1) == 0
    assert ring >= 2 * S * rounds + 16
    assert ring // 2 < max(2 * S * rounds + 16, 1024)


@pytest.mark.parametrize("table_bytes,S,rounds,force,want", [
    (89000, 4096, 5, None, ("ring", 65536)),
    (12000, 4096, 2, None, ("ring", 32768)),
    (89000, 4096, 5, "global", ("global", 0)),
    (219000, 4096, 2, None, ("global", 0)),
    (228352 - 32768, 4096, 2, None, ("ring", 32768)),
    (228352 - 32767, 4096, 2, None, ("global", 0)),
    (21636, 16384, 5, None, ("global", 0)),
    (21636, 16384, 2, None, ("ring", 131072))])
def test_choose_instance(table_bytes, S, rounds, force, want):
    """The ring where it fits the block's shared memory beside the
    tables, else the instance on global loads."""
    assert decode.choose_instance("k", table_bytes, S, rounds,
                                  force) == want


def test_choose_instance_refuses_a_ring_that_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        decode.choose_instance("k", 219000, 4096, 2, "ring")
    with pytest.raises(ValueError, match="unknown instance"):
        decode.choose_instance("k", 0, 32, 2, "smem")
