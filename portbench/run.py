"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic
mix and its metrics are found by name (portbench/manifest.py).  Set-up
makes the configuration's pool of input arrays on the card from the seed
(portbench/inputs.py), stages the mix's prepared call for each array with
the program side of the configuration's codec (encoding it first for a
read: the blob a user stores) and warms them up; the window then runs the
closed loop for `--seconds`, a request on each array in turn
(portbench/traffic.py), under torch.profiler with `--trace 1`
(portbench/trace.py).  Once the window has closed and the peak memory is
read, the program's state is freed: the outputs of a sample of the
window's requests drawn from the seed are held to their inputs (reads)
or to the codec's plain reference's encoding of their arrays (writes),
and the set-up's blobs of those arrays to the reference's (the codec's
reference side, portbench/manifest.py; portbench/check.py).

A cell of one chip runs in this process, on cuda:0.  A cell of P > 1
chips runs as P ranks, one process a card, rank r on cuda:r (a rank that
finds no such card exits with no result), each with 1/P of the CPUs for
its thread pools, joined in the program's own gloo group
(portbench/ranks.py): each rank draws its shard of every array of the
pool from (seed, rank), stages it with the program's multi-process codec
(the model from the histogram summed over the ranks) and runs the same
closed loop, the ranks meeting in shared memory after every request
(traffic.closed_loop_ranks, ranks.Meeting).  With `--trace 1` every rank
runs under the profiler, so that the ranks stay alike, and rank 0's
trace is read.  This process starts and watches the ranks and prints
rank 0's result, whose checks, blob bits and count of ranks on a card
are summed over the ranks, bpi_gap and memory_peak_bytes the largest;
`setup_s` runs from this process's start to rank 0's first timed
request, on the machine's monotonic clock (time.perf_counter), which
every process shares.  When a rank fails, or the run passes its limits,
or fewer ranks ran on a card than were started on one, every rank is
killed and no result is printed.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), device, with `--trace 1` the breakdown, and last the
numbers compared beside their limits, which also end standard error.
Without a CUDA device, or with fewer than the cell asks for, or with JAX
or the JAX package loaded once the window has closed, the run prints no
result and exits with a code other than 0.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from portbench.ranks import log  # noqa: E402

# top-level module names that may not be loaded in a run: JAX and the JAX
# package (the port, ans_tpu_torch, is another name)
BANNED = ("jax", "jaxlib", "flax", "ans_tpu")
PEAKS = "portbench/peaks.json"
# a rank of a cell over several cards: this module, from the checkout's
# root, with the rank's flags after the run's own, on the device RANK_DEVICE
# names for it (the CPU tests name "cpu")
RANK_COMMAND = [sys.executable, "-m", "portbench.run"]
RANK_DEVICE = "cuda:{rank}"
# requests of a window whose outputs the reference checks: drawn from the
# seed over the whole window (a decode's output is 128 MiB at n = 2^25)
SAMPLE = 4


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def peak_bandwidth(kind: str, root) -> float | None:
    """The card's published memory bandwidth in bytes/s, or None for a
    card the table does not hold."""
    table = json.loads((root / PEAKS).read_text())
    entry = table.get(kind)
    return float(entry["hbm_bytes_per_s"]) if entry else None


def request_bytes(kind: str, n: int, ref) -> int:
    """The bytes a request must move, counted from its shapes by the
    reference, whatever implements it: a decode reads the stream, the
    lane states and the decode table (16 bytes a frame symbol: frequency,
    base, value, exception count) once and writes 4n bytes of values; an
    encode reads the 4n bytes of symbols, the exception bytes and the
    table and writes the stream and the states.  Intermediates between
    kernels are not counted."""
    stream = sum(len(s) for s in ref.streams)
    states, table = 4 * ref.states.size, 16 * ref.sigma
    if kind == "decode":
        return stream + states + table + 4 * n
    return 4 * n + ref.exception_bytes + table + stream + states


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             started: float, n: int | None = None, opened=None,
             meet=None) -> dict:
    """One run of `cell` on this process's device; returns the result's
    fields (checks last).  `n` shortens the input (the CPU tests run the
    cell small).  Over several ranks every rank runs it, in step, meeting
    the others after each request (`meet`, a ranks.Meeting), and rank 0's
    return holds the sums over the ranks.  `opened()` is called as the
    window opens."""
    import torch

    from . import check, inputs, manifest, program, ranks, traffic
    from . import trace as tracing

    config = dict(cell.config, **({"n": n} if n else {}))
    n = int(config["n"])  # of the whole array, over every rank
    mix, codec = cell.mix, cell.codec
    shards = bool(mix.get("shards"))
    world, rank = ranks.world()
    say = log if world == 1 else (lambda *p: log(f"rank {rank}:", *p))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    marks = [time.perf_counter()]
    if shards:
        lo, hi = program.local_slice(n)
        xs = inputs.shard(config, seed, rank, hi - lo, dev)
    else:
        xs = inputs.make(config, seed, dev)
    n_here = len(xs[0])
    marks.append(time.perf_counter())
    staged = codec.program.stage(config, mix, xs, dev)
    marks.append(time.perf_counter())
    traffic.warm_up(staged.calls, sync, SAMPLE)
    ranks.barrier()
    before = program.launch_counts()
    marks.append(time.perf_counter())
    setup_s = marks[-1] - started
    if opened is not None:
        opened()
    say("set-up: " + ", ".join(
        f"{what} {b - a:.3f} s" for what, a, b in zip(
            ("imports and CUDA", "input", "encode and staging", "warm-up"),
            [started] + marks, marks)))

    def loop():
        if shards:
            return traffic.closed_loop_ranks(
                staged.calls, sync, seconds, SAMPLE, seed,
                meet or (lambda failed, stop: (failed, stop)), rank == 0)
        return traffic.closed_loop(staged.calls, sync, seconds, SAMPLE, seed,
                                   int(mix.get("clients", 1)))

    summary = None
    if trace:
        window, summary = tracing.profiled(loop, read=rank == 0)
        say(f"trace read {time.perf_counter() - started - setup_s:.1f} s "
            f"after the window opened")
    else:
        window = loop()
    after = program.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = banned_modules()
    if found:
        raise SystemExit(f"loaded in the run: {', '.join(found)}")
    say(f"window: {window.attempted} requests ({window.failed} failed) in "
        f"{window.seconds:.3f} s; set-up {setup_s:.3f} s")

    # the program's state goes before the reference runs
    kind, sections, blobs = staged.kind, staged.sections, staged.blobs
    build_ns, P = staged.model_build_ns, len(staged.calls)
    del staged
    kept = sorted(window.kept.items())
    if kind == "decode":
        kept = [(i, codec.program.decoded_values(out, n_here, sections))
                for i, out in kept]
    window.kept = {}
    # the arrays the reference encodes again: for a read, that of the
    # first sampled request (its blob); for a write, every sampled one's
    arrays = sorted({i % P for i, _ in kept})
    arrays = arrays if kind == "encode" else arrays[:1]
    t_ref = time.perf_counter()
    # a shard's model is that of every shard of its array: the reference
    # builds it from the ranks' histograms, summed by the harness
    counts = (ranks.summed_counts([xs[arrays[0]]])
              if shards and arrays else None)
    refs = {a: codec.reference.encode(config["method"], xs[a],
                                      int(config["lanes"]), sections, counts)
            for a in arrays}
    checks = check.blob([(blobs[a], refs[a].blob) for a in arrays], n_here)
    if kind == "decode":
        checks.update(check.values([(got, xs[i % P]) for i, got in kept]))
    else:
        checks.update(check.streams([(out, refs[i % P]) for i, out in kept],
                                    dev))
    say(f"checked {len(arrays)} of {P} arrays' blobs and {len(kept)} "
        f"sampled requests against the reference in "
        f"{time.perf_counter() - t_ref:.1f} s")
    blob_bits, cards = 8 * sum(len(b) for b in blobs), int(cuda)
    if world > 1:
        sums, most = ranks.reduce(
            {**{k: v for k, v in checks.items() if k != "bpi_gap"},
             "blob_bits": blob_bits, "cards": cards},
            {"bpi_gap": checks["bpi_gap"], "peak": peak})
        checks = {k: most[k] if k in most else sums[k] for k in checks}
        blob_bits, cards = sums["blob_bits"], sums["cards"]
        peak = int(most["peak"])

    kind_name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    run = SimpleNamespace(
        n=n, window=window, setup_s=setup_s, blob_bits=blob_bits, pool=P,
        model_build_ns=build_ns,
        launches={k: after[k] - before[k] for k in after},
        trace=summary, bytes=request_bytes(kind, n_here, refs[arrays[0]])
        if arrays else None,
        peak_bytes_per_s=(peak_bandwidth(kind_name, manifest.ROOT)
                          if cuda else None))
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": window.failed == 0 and check.passed(checks),
        "attempted": window.attempted, "failed": window.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": kind_name, "count": cards,
                   "memory_peak_bytes": int(peak)}}
    if window.error:
        say(f"a request failed: {window.error}")
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": check.LIMIT}
                        for k, v in checks.items()}
    return result


def run_rank(cell, args) -> int:
    """One rank of a cell over several cards (started by `main`): join the
    group, run the cell on the device the parent names, and on rank 0
    hand the result to the parent.  A rank named a card that it cannot
    find exits with code 2 before it joins: it never falls back to the
    CPU."""
    import torch

    from . import program, ranks
    ranks.die_with_parent()
    device = torch.device(args.device)
    if device.type == "cuda":
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() <= device.index):
            log(f"rank {args.rank}: no card {device}: "
                f"{torch.cuda.device_count()} visible")
            return 2
        torch.cuda.set_device(device)
    log(f"rank {args.rank}: {device}, {torch.get_num_threads()} threads")
    program.join(f"127.0.0.1:{args.port}", args.world, args.rank)
    lead = args.rank == 0
    result = run_cell(
        cell, args.seed, args.seconds, bool(args.trace), str(device),
        args.started,
        opened=(lambda: os.write(args.result_fd, b"open\n")) if lead else None,
        meet=ranks.Meeting(args.meet_fd, args.world, args.rank))
    if lead:
        with os.fdopen(args.result_fd, "wb") as out:
            out.write(b"result " + json.dumps(result).encode() + b"\n")
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the parent for each rank of a cell over several cards
    for flag, kind in (("--rank", int), ("--world", int), ("--port", int),
                       ("--meet-fd", int), ("--result-fd", int),
                       ("--started", float), ("--device", str)):
        ap.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from . import manifest
    cell = manifest.cell(args.workload)
    if args.rank is not None:
        return run_rank(cell, args)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        # one structured line, and no result: a run measures the card and
        # never falls back to the CPU
        log(json.dumps({"error": "no card", "workload": cell.name,
                        "cuda_available": torch.cuda.is_available(),
                        "devices": torch.cuda.device_count(),
                        "needs": cell.chips}))
        return 2
    card_line = card()
    log(f"{cell.name} seed {args.seed}: {card_line}")
    if cell.chips == 1:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", _STARTED)
    else:
        from . import ranks
        devices = [RANK_DEVICE.format(rank=r) for r in range(cell.chips)]
        result = ranks.launch(
            RANK_COMMAND + ["--workload", cell.name, "--seed", str(args.seed),
                            "--seconds", repr(args.seconds), "--trace",
                            str(args.trace), "--started", repr(_STARTED)],
            devices, args.seconds)
        found = banned_modules()
        if found:
            log(f"loaded in the run: {', '.join(found)}")
            return 1
        if result is None:
            return 1
        on_cards = sum(d.startswith("cuda") for d in devices)
        if result["device"]["count"] != on_cards:
            log(f"{result['device']['count']} ranks ran on a card, "
                f"{on_cards} were started on one")
            return 1
    checks = result.pop("checks")
    result.update(card=card_line, seed=args.seed, checks=checks)
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
