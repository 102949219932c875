"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with a CUDA card. Set-up draws
the cell's data from ``--seed`` on the card, loads it into the port
(``roaringbitmap_tpu_torch``, as shipped), prepares the traffic's state and
warms it with a fixed number of requests from each client; then the
clients run a closed loop for ``--seconds``. With ``--trace 1`` the window
runs under ``torch.profiler`` and the per-layer metrics are reported
instead of the end-to-end ones. Once the window has closed and the peak of
device memory is read, the port's state is freed and every answer kept
from the window is compared with the configuration's plain reference.

``--control 1`` puts the reference, with one guarantee of the
configuration broken, in the port's place: its run has to come out not
correct. The benchmark's own runs never set it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench.trace import NoDeviceEvents  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "roaringbitmap_tpu")


class HarnessError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_parts(bench: dict, name: str):
    """(cell, configuration file, traffic mix) of the cell ``name``, each
    found by its name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise HarnessError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(ROOT / entry["file"]) as f:
        cfg = json.load(f)
    with open(ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return cell, cfg, mix


def reported(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports."""
    def lists(m):
        return "workloads" not in m or cell_name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if lists(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device, control: bool = False, cfg_override: dict = None,
             mix_override: dict = None):
    """One run: (result dict, check lines). ``cfg_override`` and
    ``mix_override`` replace the cell's files (tests run tiny sizes)."""
    import numpy as np
    import torch

    from . import answers, loop
    from .reading import Reading
    from .trace import WINDOW_SPAN, profiled, read_window

    t0 = T0
    cell, cfg, mix = cell_parts(bench, cell_name)
    cfg = cfg_override or cfg
    mix = mix_override or mix
    maker = importlib.import_module(f"portbench.configs.{cfg['maker']}")
    kind = importlib.import_module(f"portbench.kinds.{mix['kind']}")
    params = mix["params"]
    clients = int(mix["clients"])
    on_cuda = device.type == "cuda"

    from roaringbitmap_tpu_torch import tracing
    from roaringbitmap_tpu_torch.models import bsi
    from roaringbitmap_tpu_torch.parallel import aggregation, store

    if not on_cuda:
        # the tests' tiny runs take the card's path, on CPU tensors with the
        # kernels' plain versions; on the card the port runs as shipped
        aggregation.config.device = bsi.config.device = device.type
        aggregation.config.mode = bsi.config.mode = "device"

    stages = {"imports": time.perf_counter() - t0}
    mark = time.perf_counter()

    def stage(name):
        nonlocal mark
        now = time.perf_counter()
        stages[name] = now - mark
        mark = now

    drawn = maker.draw(cfg, seed, device)
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    stage("draw")
    dep = maker.load(cfg, drawn, device)
    del drawn
    stage("load")
    if control:
        ctrl = kind.prepare_control(dep, params)
        call = lambda req: kind.control_call(ctrl, req)  # noqa: E731
    else:
        state = kind.prepare(dep, params)
        call = lambda req: kind.call(state, req)  # noqa: E731
    stage("prepare")
    draw = lambda rng: kind.draw(rng, dep, params)  # noqa: E731
    warm = loop.run(clients, seed, loop.WARMUP, draw, call, 0.0,
                    per_client=int(mix["warmup_per_client"]))
    warm_failed = [r.error for r in warm.requests if r.error]
    if warm_failed:
        raise HarnessError(f"warm-up request failed: {warm_failed[0]}")
    if on_cuda:
        torch.cuda.synchronize()

    before = {}

    def at_open():
        before["timings"] = tracing.timings()
        before["pack"] = store.PACK_CACHE.stats()

    def window():
        return loop.run(clients, seed, loop.WINDOW, draw, call, float(mix["keep_share"]),
                        seconds=seconds, on_open=at_open)

    if trace:
        with profiled() as holder:
            with torch.profiler.record_function(WINDOW_SPAN):
                out = window()
                if on_cuda:
                    torch.cuda.synchronize()
            timings_after, pack_after = tracing.timings(), store.PACK_CACHE.stats()
    else:
        out = window()
        if on_cuda:
            torch.cuda.synchronize()
        timings_after, pack_after = tracing.timings(), store.PACK_CACHE.stats()
    setup_s = out.opened - t0
    stages["warm-up"] = out.opened - mark

    in_window = [r for r in out.requests if r.end <= out.closed]
    done = [r for r in in_window if r.error is None]
    failed = [r for r in out.requests if r.error is not None]
    if not done:
        raise HarnessError("no request completed inside the window")
    peak = int(torch.cuda.max_memory_allocated(device)) if on_cuda else 0

    dw = read_window(holder.pop("trace")) if trace else None
    least = None
    if trace:
        works = [kind.least_seconds(dep, params, r.request) for r in done]
        if all(w is not None for w in works):
            least = float(sum(works))
    reading = Reading(
        seconds=seconds, completed=len(done), setup_s=setup_s,
        latencies_ms=np.array([(r.end - r.start) * 1e3 for r in done]),
        least_s=least, device=dw,
        timings_before=before["timings"], timings_after=timings_after,
        pack_before=before["pack"], pack_after=pack_after,
    )
    metrics = {}
    for m in reported(bench, cell_name, trace):
        value = importlib.import_module(f"portbench.metrics.{m['name']}").read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the port's state goes before the reference runs on the card
    state = ctrl = call = None
    dep.free_program()
    store.PACK_CACHE.close()
    if on_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    kept = [r for r in out.requests if r.keep and r.error is None]
    wrong = 0
    off_total = 0
    for r in kept:
        off = answers.off_by(kind.expected(dep, params, r.request), r.answer)
        wrong += off > 0
        off_total += off
    ref_s = time.perf_counter() - t_ref
    checks = {
        "wrong_answers": {"value": wrong, "limit": 0, "holds": wrong <= 0},
        "failed_requests": {"value": len(failed), "limit": 0, "holds": len(failed) <= 0},
        "compared_answers": {"value": len(kept), "limit": 1, "holds": len(kept) >= 1},
    }
    correct = all(c["holds"] for c in checks.values())
    lines = [
        "set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()),
        f"compared {len(kept)} answers in {ref_s:.3f} s; values off in all: {off_total}",
        f"check wrong_answers {wrong} <= limit 0",
        f"check failed_requests {len(failed)} <= limit 0",
        f"check compared_answers {len(kept)} >= limit 1",
    ]
    if failed:
        lines.insert(0, f"first failed request: {failed[0].error}")
    device_info = {
        "platform": "gpu" if on_cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if on_cuda else device.type,
        "count": int(cell["chips"]),
        "memory_peak_bytes": peak,
    }
    result = {
        "correct": bool(correct),
        "attempted": len(out.requests),
        "failed": len(failed),
        "metrics": metrics,
        "device": device_info,
    }
    if trace:
        device_info["busy_s"] = dw.busy_s
        device_info["window_s"] = dw.window_s
        result["breakdown"] = {
            "device_ops": [[n, v] for n, v in dw.device_ops],
            "idle_gaps": [[n, v] for n, v in dw.idle_gaps],
        }
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        print("--seconds must be positive", file=sys.stderr)
        return 2
    try:
        bench = load_benchmark()
        cell, _cfg, _mix = cell_parts(bench, args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        result, lines = run_cell(bench, args.workload, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0),
                                 control=bool(args.control))
    except (HarnessError, NoDeviceEvents) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules that must not load are loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
