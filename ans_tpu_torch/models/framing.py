"""Lane-format blob framing (docs/FORMAT.md section 2, fmt 2): a NumPy
copy of ans_tpu/models/framing.py, held equal to it by
tests/test_torch_host.py.

After the method header + prelude comes:

    u8  fmt          (2 = lockstep: u32 state, 8-bit renorm, shared stream)
    u8  log2(S)
    u16 num_sections (>= 1)
    u32 stream_len   little-endian
    u32 t_sec        steps per section (multiple of 32; last may be short)
    u32 section_len[num_sections]   bytes per section
    u32 init_state[S]    (final encoder states)
    shared stream bytes (= concatenated sections; decode reads forward)

Sections are contiguous step-aligned slices of one stream, so the CUDA
decoder reads the concatenated payload with one global cursor; t_sec and
the section lengths are still chosen here because they are wire format
(choose_sections for one stream; choose_sections_joint, one t_sec for the
D streams of a blocked container, as ans_tpu's production engine cuts
them).
"""

from __future__ import annotations

import numpy as np

FMT_LOCKSTEP = 2


def pack(states: np.ndarray, stream: np.ndarray, t_sec: int,
         sec_len: np.ndarray) -> bytes:
    S = len(states)
    log2s = S.bit_length() - 1
    if 1 << log2s != S:
        raise ValueError(f"lane count {S} is not a power of two")
    nsec = len(sec_len)
    out = bytearray()
    out += bytes((FMT_LOCKSTEP, log2s))
    out += int(nsec).to_bytes(2, "little")
    out += int(len(stream)).to_bytes(4, "little")
    out += int(t_sec).to_bytes(4, "little")
    out += np.asarray(sec_len, dtype="<u4").tobytes()
    out += np.asarray(states, dtype="<u4").tobytes()
    out += np.asarray(stream, dtype=np.uint8).tobytes()
    return bytes(out)


def parse(buf: bytes, off: int):
    """Returns (S, states u32 (S,), stream u8 view, t_sec, sec_len)."""
    fmt, log2s = buf[off], buf[off + 1]
    if fmt != FMT_LOCKSTEP:
        raise ValueError(f"unknown lane format {fmt}")
    S = 1 << log2s
    nsec = int.from_bytes(buf[off + 2:off + 4], "little")
    stream_len = int.from_bytes(buf[off + 4:off + 8], "little")
    t_sec = int.from_bytes(buf[off + 8:off + 12], "little")
    p = off + 12
    sec_len = np.frombuffer(buf, dtype="<u4", count=nsec, offset=p).astype(
        np.int64)
    p += 4 * nsec
    states = np.frombuffer(buf, dtype="<u4", count=S, offset=p).copy()
    p += 4 * S
    stream = np.frombuffer(buf, dtype=np.uint8, count=stream_len, offset=p)
    return S, states, stream, t_sec, sec_len


def choose_sections_joint(step_bases, totals, T: int,
                          cap_bytes: int = 3 << 20, quantum: int = 32):
    """One t_sec valid for EVERY device's stream (the block runtime
    forces a uniform decode grid across the mesh).  Taking min() of
    per-device choose_sections results is NOT safe: the halving chain
    is not a divisor chain, so a smaller t_sec re-cuts a stream at
    boundaries it never validated and a section straddling a validated
    cut can reach ~2x cap_bytes (VMEM OOM at decode).  Returns
    (t_sec, [per-device sec_len arrays])."""
    if T == 0:
        return quantum, [np.array([int(t)], dtype=np.int64)
                         for t in totals]
    t_sec = -(-T // quantum) * quantum
    boundss = [np.append(sb, int(tot))
               for sb, tot in zip(step_bases, totals)]
    while True:
        cuts = np.arange(0, T, t_sec)
        ends = np.minimum(cuts + t_sec, T)
        lens = [b[ends] - b[cuts] for b in boundss]
        if (max(int(ln.max()) for ln in lens) <= cap_bytes
                or t_sec <= quantum):
            return t_sec, [ln.astype(np.int64) for ln in lens]
        t_sec = max(quantum, (t_sec // 2 // quantum) * quantum)


def choose_sections(step_base: np.ndarray, total: int, T: int,
                    cap_bytes: int = 3 << 20, quantum: int = 32):
    """Pick t_sec (multiple of `quantum`) so every aligned section of
    t_sec steps spans <= cap_bytes; returns (t_sec, sec_len array)."""
    if T == 0:
        return quantum, np.array([total], dtype=np.int64)
    t_sec = -(-T // quantum) * quantum
    bounds = np.append(step_base, total)
    while True:
        cuts = np.arange(0, T, t_sec)
        ends = np.minimum(cuts + t_sec, T)
        lens = bounds[ends] - bounds[cuts]
        if lens.max() <= cap_bytes or t_sec <= quantum:
            return t_sec, lens.astype(np.int64)
        t_sec = max(quantum, (t_sec // 2 // quantum) * quantum)
