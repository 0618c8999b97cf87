"""The benchmark of ``deepqlearning_tpu_torch`` on one NVIDIA GPU.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card this process sees: builds
the port's actor-learner loop from the cell's configuration and traffic
and the seed, warms it up, times segments of its CUDA graph for
``--seconds``, checks what the loop computed against the plain reference,
and prints one JSON line last: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics from a device trace), ``device`` and, last, ``checks``
(each correctness number beside its limit, also the last lines on
standard error). Exits non-zero, printing no result, without CUDA, with
fewer cards than the cell asks for, or when JAX or the JAX package were
loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "deepqlearning_tpu")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from port_bench.harness.bench import run_cell
    from port_bench.harness.registry import Registry

    reg = Registry()
    chips = next((w["chips"] for w in reg.bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda:0"), T0, reg,
                      log=lambda s: print(s, file=sys.stderr))
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
