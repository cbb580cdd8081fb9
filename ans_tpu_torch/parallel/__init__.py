"""The blocked container (ATFB) on one device: D sections of one input
coded with one shared model, as D streams of one batch (counterpart of
ans_tpu/parallel/)."""

from .block_runtime import (KINDS, MAGIC, BlockCodec,  # noqa: F401
                            decode_blocked, describe_container,
                            encode_blocked)
