"""Seconds of the host model half of the set-up's encodes, over the pool's
arrays (mapping, frame search, prelude, escape plan), as the program
records them: in ans_tpu_torch.utils.stats (prelude_time_ns) for the
one-stream read cells, whose set-up encodes through `codec.encode`; the
self time of its `model.build` spans for a sharded cell, whose set-up
encodes through `MultiHostBlockCodec.encode_local` (portbench/program.py;
rank 0's shards)."""


def read(run):
    if run.model_build_ns is None:
        return None
    return run.model_build_ns / 1e9
