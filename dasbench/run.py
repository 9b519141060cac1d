"""One run of one cell of the benchmark of das_tpu_torch.

    python3 dasbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from the cell's entry in BENCHMARK.json: the
configuration `dasbench/configs/<config>.json` and its generator
`dasbench/gen/<config>.py`, the traffic mix `dasbench/traffic/<traffic>.json`,
its driver `dasbench/drivers/<driver>.py` and query families
`dasbench/reference/<family>.py`, and one reader per metric,
`dasbench/metrics/<metric>.py`.  Files whose names hold dots are loaded
by path.

A run, in one process: generate the KB from the seed, write it as a
canonical file under TMPDIR, load it with
`DistributedAtomSpace.load_canonical_knowledge_base` (the columnar
route), delete the file, attach the store to a `DasService` tenant,
draw the window's requests and a disjoint warm-up set, send the warm-up,
then measure for `--seconds`; once the window has closed and the card's
memory peak is read, free the program's state and compare the answers
with the NumPy reference (dasbench/reference/).  `--trace 1` turns on the
program's spans and a device trace and reports the per-layer metrics;
`--trace 0` the end-to-end ones.

Standard output ends with the set-up split, then one JSON line (correct,
attempted, failed, metrics, device, breakdown with --trace 1, and the
compared numbers with their limits last); standard error ends with the
compared numbers beside their limits.  Without a CUDA card, or with
fewer cards than the cell asks for, it exits 3 and prints no result; it
exits 4 when JAX or das_tpu was loaded in this process.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "dasbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names a run may not have loaded (compared whole: the
#: port, das_tpu_torch, begins with das_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "das_tpu")


class NoCard(RuntimeError):
    pass


def load_path(path: Path, name: str):
    """A module from a file whose name may hold dots."""
    if not path.is_file():
        raise FileNotFoundError(f"dasbench: {path} is missing")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"dasbench: {path} is missing")
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, bench: dict = None, root: Path = ROOT) -> SimpleNamespace:
    """Everything a cell names, found by name: its configuration entry and
    file, generator, traffic mix, driver, families and metric readers."""
    bench = bench or read_json(root / "BENCHMARK.json")
    here = root / "dasbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"dasbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = read_json(root / config_entry["file"])
    traffic = read_json(here / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return SimpleNamespace(
        cell=cell, config=config, traffic=traffic,
        generator=load_path(here / "gen" / f"{cell['config']}.py", f"dasbench_gen_{cell['config']}"),
        driver=load_path(here / "drivers" / f"{traffic['driver']}.py",
                         f"dasbench_driver_{traffic['driver']}"),
        families=[importlib.import_module(f"dasbench.reference.{name}")
                  for name, _w in traffic["families"]],
        e2e=e2e, layer=layer, ix=None,
        readers={m["name"]: load_path(here / "metrics" / f"{m['name']}.py",
                                      f"dasbench_metric_{m['name']}")
                 for m in e2e + layer},
    )


def draw(spec, kb, seed: int, n: int, stream: int):
    """`n` requests (rounded up to whole blocks of the mix) as (family
    index, params) in a seeded order: each block of sum(weights) requests
    holds each family its weight's number of times."""
    from dasbench import bio
    from dasbench.reference.index import LinkIndex

    rng = bio.rng_for(seed, stream)
    if spec.ix is None:
        spec.ix = LinkIndex(kb)
    ix = spec.ix
    weights = [int(w) for _name, w in spec.traffic["families"]]
    block = sum(weights)
    blocks = max(1, math.ceil(n / block))
    params = [fam.draw(kb, ix, rng, blocks * w) for fam, w in zip(spec.families, weights)]
    slots = [f for f, w in enumerate(weights) for _ in range(w)]
    used = [0] * len(weights)
    out = []
    for _b in range(blocks):
        for f in rng.permutation(slots).tolist():
            out.append((f, tuple(int(x) for x in params[f][used[f]])))
            used[f] += 1
    return out


def card_check(chips: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"dasbench: needs {chips} CUDA card(s); "
                     f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                     f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             config_overrides: dict = None, root: Path = ROOT, t_process: float = None,
             faults=None) -> dict:
    """One run; returns the result dict (the last line's object).
    `device="cpu"`, `config_overrides` and `faults` (a callable that breaks
    the timed path once the store is loaded) are for the tests, which
    drive a run on the CPU at a small size."""
    import torch

    from das_tpu_torch.api.atomspace import DistributedAtomSpace

    from dasbench import bio
    from dasbench import kb as kbmod
    from dasbench import trace as tracing
    from dasbench.reference import check as checker

    t_process = T_PROCESS if t_process is None else t_process
    spec = resolve(workload, root=root)
    config = dict(spec.config, **(config_overrides or {}))
    cuda = device == "cuda"
    if cuda:
        card_check(int(spec.cell["chips"]))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    parts = {}

    t = time.perf_counter()
    kb = spec.generator.generate(config, seed)
    tmp = tempfile.mkdtemp(prefix="dasbench-")
    try:
        path = os.path.join(tmp, "kb.metta")
        kbmod.write_canonical(kb, path)
        parts["generate_s"] = time.perf_counter() - t
        t = time.perf_counter()
        das = DistributedAtomSpace(backend=config["layout"]["backend"],
                                   device=None if cuda else device)
        das.load_canonical_knowledge_base(path)
        sync()
        parts["load_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t = time.perf_counter()
    driver = spec.driver.Driver(das, spec.traffic)
    parts["attach_s"] = time.perf_counter() - t

    t = time.perf_counter()
    pool_n = int(math.ceil(spec.traffic["pool_per_second"] * seconds))
    requests = draw(spec, kb, seed, pool_n, stream=3)
    dsl = [spec.families[f].dsl(kb, p) for f, p in requests]
    in_window = set(dsl)
    warm_n = int(spec.traffic["warm_per_family"]) * len(spec.families)
    warm = [spec.families[f].dsl(kb, p) for f, p in draw(spec, kb, seed, 2 * warm_n, stream=4)]
    warm = [q for q in warm if q not in in_window][:warm_n]
    parts["draw_s"] = time.perf_counter() - t
    if faults is not None:
        faults()

    t = time.perf_counter()
    driver.warm(warm)
    sync()
    parts["warm_s"] = time.perf_counter() - t

    # every run enters its window with the collector in the same state
    gc.collect()
    session = None
    if trace:
        session = tracing.Session(driver, cuda)
        session.start()
    serving0 = driver.stats()
    with tracing.GcPauses() as collections:
        window = driver.measure(dsl, seconds)
    sync()
    serving = serving_window(serving0, driver.stats())
    if window.exhausted:
        raise RuntimeError(f"dasbench: the {len(dsl)} requests drawn ran out inside the "
                           "window; raise pool_per_second in the traffic file")
    setup_s = window.t_start - t_process
    done = [i for i in window.sent if window.ends[i] <= window.t_end]
    observed = None
    if session is not None:
        observed = tracing.Observed(window_s=window.t_end - window.t_start,
                                    t_start=window.t_start, t_end=window.t_end,
                                    completed=len(done), gc_pauses=collections.pauses)
        session.stop(observed)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the program's state goes before the reference runs
    del driver, das, session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    handles = checker.HandleMap(kb)
    rng = bio.rng_for(seed, 5)
    check_cfg = spec.traffic["check"]
    chosen = checker.sample(window.statuses, rng, int(check_cfg["max"]),
                            int(check_cfg["longest"]))
    result = checker.check(kb, spec.families, requests, window.statuses, window.sent,
                           chosen, handles, spec.ix)
    check_s = time.perf_counter() - t
    wrong_idx = set(result.pop("wrong_idx", ()))
    compared = {k: {"value": result[k], "limit": v} for k, v in checker.LIMITS.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values()) and result["checked"] > 0

    ctx = SimpleNamespace(window=window, seconds=seconds, setup_s=setup_s, setup=parts,
                          done=done, wrong=wrong_idx, observed=observed)
    metrics = {}
    for m in (spec.layer if trace else spec.e2e):
        value = spec.readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for i in done if not window.statuses[i]["success"] or i in wrong_idx)
    out = {"correct": bool(correct), "attempted": len(done), "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                      "count": int(spec.cell["chips"]) if cuda else 0,
                      "memory_peak_bytes": int(memory_peak)}}
    if observed is not None:
        out["device"]["busy_s"] = observed.busy_s
        out["device"]["window_s"] = observed.window_s
        out["breakdown"] = tracing.breakdown(observed)
        out["_unknown_kernels"] = tracing.unknown_kernels(observed)
    out["_setup"] = dict(parts, setup_s=setup_s, check_s=check_s, checked=result["checked"],
                         nonempty=result["nonempty"], first_wrong=result["first_wrong"],
                         sent=len(window.sent), completed_in_window=len(done),
                         per_5s=timeline(window, done, 5.0),
                         gc=collections.summary(window.t_start, window.t_end, 5.0),
                         serving=serving)
    out["checks"] = compared
    return out


def serving_window(before: dict, after: dict) -> dict:
    """The coalescer over the window: its batches and items, and where
    its adaptive window (depth from the rtt and dispatch-cost EWMAs)
    stood at the close and over its last settled groups."""
    history = [h[2] for tenant in after.get("tenants", {}).values()
               for h in tenant.get("window_history", [])]
    return {"batches": after["batches"] - before["batches"],
            "items": after["items"] - before["items"],
            "effective_depth": after["effective_depth"],
            "rtt_ewma_ms": after["rtt_ewma_ms"], "dispatch_ewma_ms": after["dispatch_ewma_ms"],
            "depth_history": sorted(set(history))}


def timeline(window, done, step: float):
    """Requests answered in each `step` seconds of the window: a rate that
    drifts inside the window shows here."""
    counts = [0] * max(1, math.ceil(round((window.t_end - window.t_start) / step, 6)))
    for i in done:
        counts[min(len(counts) - 1, int((window.ends[i] - window.t_start) / step))] += 1
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as exc:
        print(exc, file=sys.stderr, flush=True)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"dasbench: this process loaded {bad}; the benchmark measures "
              "das_tpu_torch alone", file=sys.stderr, flush=True)
        return 4
    for name in out.pop("_unknown_kernels", []):
        print(f"dasbench: device kernel outside the byte model: {name}", flush=True)
    setup = out.pop("_setup")
    print("setup " + json.dumps(setup), flush=True)
    print("card " + power_limit(), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
