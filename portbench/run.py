"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in ``setup_s``): the graph from the seed, the weights on
the card from the seed, the port's server (``repro_torch``) started, and
the traffic's ``fill`` top-ranked targets served once, which warms the
caches and runs every shape of the window. Then one window of
``--seconds`` under the cell's traffic, traced by ``torch.profiler`` (the
card's kernel time is an end-to-end metric; ``--trace 1`` reports the
per-layer metrics and the breakdown). Then, with the program's state freed, the
answers are judged against the plain reference (``portbench/reference``).
The last lines of standard error name each number compared beside its
limit; the last line of standard output is the result, as JSON. Needs a
CUDA card: without one, it exits with code 2 and prints no result.
"""
from __future__ import annotations

import time

T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # import portbench as a package, and keep this folder's module names
    # out of the top level
    sys.path[0] = str(ROOT)
if str(ROOT / "src") not in sys.path:
    sys.path.insert(1, str(ROOT / "src"))     # the port, from the checkout
# every build and kernel cache of the run at a fixed path in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from portbench import check, graphgen, load, spec  # noqa: E402
from portbench.devtrace import DeviceTrace, Profiled, is_copy  # noqa: E402
from portbench.record import Record  # noqa: E402
from portbench.serving import System, make_params  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoChip(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) \
            - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


def deploy(cfg: dict, traffic: dict, seed: int, device: str, impl: str):
    """The set-up every run pays: (graph, the support ranked hottest first,
    weights, the started system with its caches filled). Where the
    configuration sets ``host_threads``, torch's CPU work runs on that many
    threads."""
    if "host_threads" in cfg:
        torch.set_num_threads(int(cfg["host_threads"]))
    graph = graphgen.make_run_graph(graphgen.GraphSpec(**cfg["graph"]),
                                    seed)
    ranked = graphgen.ranked(graph, traffic["support"])
    params = make_params(cfg, seed, device)
    system = System(graph, cfg, params, device, impl)
    system.fill(ranked[:traffic["fill"]][::-1])
    return graph, ranked, params, system


def card_info(t) -> str:
    """The card's busy, kernel and copy milliseconds a batch, over the
    batches launched in the window (``DeviceTrace.launch_span``)."""
    span = t.launch_span()
    if span is None:
        return "info card_ms_per_batch none"
    a, b, k = span
    kern = t.kernels()
    copies = DeviceTrace(t.window_s, [o for o in t.ops if is_copy(o[0])])
    return "info card_ms_per_batch " + " ".join(
        f"{n} {1e3 * x.busy_s_between(a, b) / k!r}"
        for n, x in (("busy", t), ("kernels", kern), ("copies", copies)))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", impl: str = None,
             require_chip: bool = True, overrides: dict = None,
             root: Path = ROOT, also=None):
    """One run of one cell: (result dict, info lines, checks). Tests pass
    ``device="cpu"``, ``require_chip=False`` and smaller ``overrides``
    ({"config": {...}, "traffic": {...}}); ``also(window, graph, cfg,
    params, device, seed)``, where given, runs after the checks (the
    control's readings)."""
    overrides = overrides or {}
    bench = spec.benchmark(root)
    cell = spec.cell(bench, workload)
    cfg = _merge(spec.config(bench, cell["config"], root),
                 overrides.get("config"))
    traffic = _merge(spec.traffic(cell["traffic"], root / "portbench"),
                     overrides.get("traffic"))
    if require_chip and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        raise NoChip(f"cell {workload} needs {cell['chips']} CUDA card(s); "
                     f"torch sees {torch.cuda.device_count()}")
    on_card = device.startswith("cuda")

    t_deploy = time.monotonic()
    graph, ranked, params, system = deploy(cfg, traffic, seed, device,
                                           impl or cfg["impl"])
    t_deploy = time.monotonic() - t_deploy
    targets, due = load.plan(traffic, ranked, seed, seconds)
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age_s()

    readers = [(m, spec.reader(m["name"], root / "portbench"))
               for m in spec.metrics_for(bench, workload, trace)]

    def counters() -> dict:
        """The system's counters, and each reader's own snapshot of the
        program under the metric's name."""
        got = system.counters()
        for m, r in readers:
            if hasattr(r, "snapshot"):
                got[m["name"]] = r.snapshot(system)
        return got

    system.record_spans()
    prof = Profiled().__enter__()
    prof.mark()
    before = counters()
    after = {}

    def on_close():
        after.update(counters())
        prof.__exit__(None, None, None)

    window = load.run(system.submit, traffic, targets, due, seconds,
                      system.answered, on_close)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    system.close()
    spans = system.spans
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded in the run's process: {found}")

    dtrace = prof.reduce(window.t0, window.t_close, spans)
    t_ref = time.monotonic()
    checks, compared = check.judge(window.sent, graph, cfg, params, device,
                                   seed)
    t_ref = time.monotonic() - t_ref
    if also is not None:
        also(window, graph, cfg, params, device, seed)
    rec = Record(cfg, traffic, window, setup_s, before, after, dtrace)
    metrics = {}
    for m, r in readers:
        v = r.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    never = int(next(c.value for c in checks if c.name == "never_came"))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks),
              "attempted": len(window.sent), "failed": never,
              "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": dtrace.idle_gaps()}
    late = float(max((s.t_sent - s.t_due for s in window.sent),
                     default=0.0))
    info = [f"info requests {len(window.sent)} answered_in_window "
            f"{len(window.answered_in_window())} compared {compared}",
            f"info batches {after['batches'] - before['batches']} "
            f"generator_late_max_s {late!r}",
            f"info setup_s {setup_s!r} deploy_s {t_deploy!r} "
            f"check_s {t_ref!r}",
            f"info graph_edges {len(graph.indices)} mean_degree "
            f"{len(graph.indices) / graph.num_vertices!r}",
            card_info(dtrace)]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, info, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, info, checks = run_cell(args.workload, args.seed,
                                        args.seconds, bool(args.trace))
    except NoChip as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except Forbidden as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for line in info + [c.line() for c in checks]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
