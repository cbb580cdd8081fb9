"""Lane-count policy: a copy of ans_tpu/models/config.py, held equal to
it by tests/test_torch_host.py.  The default lane count is wire format:
it decides what `encode()` writes by default."""

from __future__ import annotations


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def validate_lanes(lanes: int | None) -> int | None:
    """Lane counts must be powers of two: the fmt-2 section header
    stores log2(S) (framing.pack)."""
    if lanes is not None and (lanes < 1 or lanes & (lanes - 1)):
        raise ValueError(f"lanes must be a power of two, got {lanes}")
    return lanes


def default_lane_count(n: int, min_lanes: int = 32,
                       max_lanes: int = 4096) -> int:
    """Lanes S for an n-element block: S ~ n/12800 (each lane costs 4
    bytes of flushed state), a power of two clamped to [32, 4096]."""
    if n <= 0:
        return min_lanes
    return min(max_lanes, max(min_lanes, next_pow2(-(-n // 12800))))
