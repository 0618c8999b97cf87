"""Readings that the correctness limits are set from, for one cell.

    python3 port_bench/readings.py --workload <cell> --seeds 1,2,3 \
        [--variants program,control,half_batch,altered,unchanged,...]

For each seed: the benchmark's set-up and its three checked iterations of
the port's loop, then the plain reference from the same state, and the
correctness numbers (``harness/check.py``) of each variant against the
reference: ``program`` (the port, as a run judges it); ``control`` (the
reference itself in the precision just below the configuration's, TF32
for f32 and scaled e4m3 products for bf16, in the port's place);
``half_batch`` (the reference with half of each batch left out, the mean
over the rest); ``altered`` (the reference with one env's reward altered
where the collect produces it); ``unchanged`` (a step that returns its
state unchanged, read without a run); and of a recurrent cell, the
reference with ``no_reset`` (the recurrent state not zeroed at an
episode's end), ``skip_update`` (the last sub-update of each iteration
left out) or ``no_mask`` (the window's mask left out of the loss). Without
``--variants``, every variant that the cell's route has. No timed window:
training's readings need none. Prints one JSON line per seed and variant.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = ("program", "control", "half_batch", "altered", "unchanged")
RECURRENT = ("no_reset", "skip_update", "no_mask")


def readings(name, seed, variants, device, reg=None):
    import gc

    import torch

    from port_bench.harness import check, program, work
    from port_bench.harness.bench import N_CHECKED
    from port_bench.harness.registry import Registry
    from port_bench.reference.loop import follow
    from port_bench.reference.nets import Precision

    reg = reg or Registry()
    cell = reg.cell(name)
    config = reg.config(cell["config"])
    tr = work.traffic(config, cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    p = program.build(config, tr, seed, device, reg)
    start, prog, rows, _ = program.checked(p, N_CHECKED)
    del p
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {}
    exact = None
    for v in variants:
        t0 = time.perf_counter()
        if v == "program":
            ref = follow(config, tr, start, device, rows, reg)
            nums = dict(check.numbers(start, prog, ref), **ref["ties"])
        elif v == "unchanged":
            exact = exact or follow(config, tr, start, device,
                                    [None] * N_CHECKED, reg)
            nums = check.unchanged(start, exact)
        else:
            prec = Precision("tf32" if config["dtype"] == "float32"
                             else "fp8") if v == "control" else None
            stand_in = follow(config, tr, start, device,
                              [None] * N_CHECKED, reg, prec=prec,
                              fault=None if v == "control" else v,
                              keep_rows=True)
            nums = check.numbers(start, stand_in, follow(
                config, tr, start, device, stand_in["rows"], reg))
        out[v] = dict(nums, seconds=time.perf_counter() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants")
    args = ap.parse_args(argv)
    import torch

    from port_bench.harness.registry import Registry

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    reg = Registry()
    variants = (args.variants.split(",") if args.variants else VARIANTS + (
        RECURRENT if "recurrence" in reg.config(
            reg.cell(args.workload)["config"]) else ()))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = readings(args.workload, seed, variants,
                       torch.device("cuda:0"), reg)
        for v, nums in res.items():
            print(json.dumps(dict(workload=args.workload, seed=seed,
                                  variant=v, **nums)), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
