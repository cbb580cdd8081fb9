"""The control of `correct`: the plain reference put in the program's place
with the configuration's guarantee broken, read by the same comparison.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--n N]

The configurations state no precision; they state lossless coding.  The
control keeps only each value's high part (the codec's `lossy_values`;
the lane codec's, reference.lossy_values, loses the low bytes a byte fold
strips) and codes that with the codec's plain reference: the blob it
writes, the values its decode returns and the streams its encode returns
stand where the program's would, and portbench/check.py judges them
against the lossless reference of the input: the pool's first array,
made on the device as a run makes it.  In a sharded cell, rank 0's shard
of it, the model (the program's and the control's alike) from the counts
of every rank's shard.
Each seed's numbers are printed beside their limits, then one JSON line
with every seed's readings and the least of each (the upper reading the
limits are set below).  The control must fail; the benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import check, inputs, manifest, ranks


def readings(cell, seed: int, device, n: int | None = None) -> dict:
    """The compared numbers of the control in `cell` for `seed`."""
    config = dict(cell.config, **({"n": n} if n else {}))
    n = int(config["n"])
    method, lanes = config["method"], int(config["lanes"])
    sections = int(cell.mix.get("sections", 0))
    reference = cell.codec.reference
    if cell.mix.get("shards"):
        per = -(-n // cell.chips)
        shards = [inputs.shard(config, seed, r, min(per, n - r * per),
                               device, count=1)[0]
                  for r in range(cell.chips)]
        lossy = [reference.lossy_values(s) for s in shards]
        counts, lossy_counts = (ranks.summed_counts(a)
                                for a in (shards, lossy))
        x, lossy = shards[0], lossy[0]
    else:
        x = inputs.make(config, seed, device, count=1)[0]
        lossy, counts, lossy_counts = reference.lossy_values(x), None, None
    ref = reference.encode(method, x, lanes, sections, counts)
    ctl = reference.encode(method, lossy, lanes, sections, lossy_counts)
    out = check.blob([(ctl.blob, ref.blob)], len(x))
    if cell.mix["call"] == "decode":
        out.update(check.values(
            [(torch.from_numpy(lossy.view(np.int32)).to(device), x)]))
    else:
        stream = torch.from_numpy(np.concatenate(ctl.streams)).to(device)
        states = torch.from_numpy(ctl.states.view(np.int32)).to(device)
        out.update(check.streams([((stream, states), ref)], device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--n", type=int, default=None,
                    help="values (default: the configuration's)")
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    seeds = [int(s) for s in args.seeds.split(",")]
    per_seed = {}
    for seed in seeds:
        t0 = time.perf_counter()
        per_seed[seed] = r = readings(cell, seed, device, args.n)
        print(f"{cell.name} seed {seed} ({time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{k} {v} limit {check.LIMIT}"
                          for k, v in r.items()), file=sys.stderr)
    least = {k: min(r[k] for r in per_seed.values())
             for k in next(iter(per_seed.values()))}
    print(json.dumps({"workload": cell.name, "device": str(device),
                      "n": args.n or cell.config["n"],
                      "control_fails": not check.passed(least),
                      "least": least, "per_seed": per_seed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
