"""One run of one cell: the pieces found by name, set-up, the window, the
check, the result line.

``BENCHMARK.json`` names the cell; its configuration is
``portbench/configs/<config>.json``, its traffic mix
``portbench/traffic/<traffic>.json``, whose ``driver`` names the general
generator ``portbench/drivers/<driver>.py``, the limits of its check are
``portbench/limits/<cell>.json``, and each metric is read by
``portbench/metrics/<metric>.py``.  Nothing here knows a cell.

A driver module has ``setup(run)``, ``unit(run) -> dict``,
``install_probes(run) -> [Probe]`` and ``check(run) -> Verdict``.  A metric
module has ``read(run) -> float | None`` (None: nothing to read, the metric
is left out) and may have ``probe(run) -> Probe``, installed for the window
of a traced run.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench.harness import device as dev

ROOT = Path(__file__).resolve().parents[1]  # portbench/
REPO = ROOT.parent


@dataclass
class Number:
    """One number compared, and its limit: it passes at or below it (NaN
    fails)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Verdict:
    attempted: int
    failed: int
    numbers: list

    @property
    def correct(self) -> bool:
        return self.attempted > 0 and self.failed == 0 and all(n.ok for n in self.numbers)


@dataclass
class Run:
    """What a driver and a metric reader see of one run."""

    config: dict
    mix: dict
    seed: int
    limits: dict = field(default_factory=dict)
    device: str = "cuda"
    spans: dev.Spans = field(default_factory=dev.Spans)
    units: list = field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    trace_summary: object = None
    values: dict = field(default_factory=dict)  # what a driver's check leaves for the metrics
    state: dict = field(default_factory=dict)  # the driver's own
    metric_state: dict = field(default_factory=dict)  # name -> what a metric's probe recorded


def load_module(path: Path):
    """The module in ``path``, whose name may hold dots or dashes."""
    name = "portbench_piece_" + "".join(c if c.isalnum() else "_" for c in f"{path.parent.name}/{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_pieces(bench: dict, name: str, root: Path = ROOT):
    """(cell, configuration entry, configuration, mix, driver module,
    end-to-end metric entries, per-layer metric entries) of the cell
    ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(root.parent / conf_entry["file"])
    mix = load_json(root / "traffic" / f"{cell['traffic']}.json")
    driver = load_module(root / "drivers" / f"{mix['driver']}.py")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return cell, conf_entry, config, mix, driver, e2e, layers


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc``."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def execute(bench: dict, name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
            root: Path = ROOT, log=None, after=None) -> dict:
    """One run of the cell ``name``: returns the result line's object.
    ``after(run, driver)``, if given, is called once the check is done (the
    control's readings use it)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    _, _, config, mix, driver, e2e, layers = cell_pieces(bench, name, root)
    metrics = {m["name"]: (m, load_module(root / "metrics" / f"{m['name']}.py"))
               for m in (layers if trace else e2e)}
    run = Run(config=config, mix=mix, seed=seed, limits=load_json(root / "limits" / f"{name}.json"),
              device=device)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ---- set-up: the pieces, the program, one warm unit of the cell's own traffic
    with run.spans.span("setup"):
        driver.setup(run)
        with run.spans.span("warm unit"):
            driver.unit(run)
        sync()
    probes = []
    if trace:
        for _, mod in metrics.values():
            if hasattr(mod, "probe"):
                p = mod.probe(run)
                if p is not None:
                    probes.append(p.install())
    probes += [p.install() for p in driver.install_probes(run)]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = process_age_s()
    log(f"[portbench] {name} seed {seed}: set-up {run.setup_s:.3f} s")

    # ---- the window: units back to back; it closes at the end of the first
    # unit that ends at or after ``seconds``; a traced run profiles its first
    # unit
    t0 = time.perf_counter()
    try:
        while True:
            if trace and not run.units and cuda:
                t_before = time.perf_counter()
                with dev.cuda_trace() as prof:
                    t_in, u0 = time.perf_counter(), time.time_ns()
                    with run.spans.span("unit"):
                        run.units.append(driver.unit(run))
                    sync()
                    t_out, u1 = time.perf_counter(), time.time_ns()
                run.trace_summary = dev.read_trace(prof, u0, u1, run.spans)
                del prof
                # the profiler's start, stop and the trace's read are not the window's
                t0 += (t_in - t_before) + (time.perf_counter() - t_out)
            else:
                t_in = time.perf_counter()
                with run.spans.span("unit"):
                    run.units.append(driver.unit(run))
                sync()
                log(f"[portbench] unit {len(run.units)}: {time.perf_counter() - t_in:.3f} s")
            if time.perf_counter() - t0 >= seconds:
                break
    finally:
        for p in reversed(probes):
            p.remove()
    run.window_s = time.perf_counter() - t0
    log(f"[portbench] window {run.window_s:.3f} s, {len(run.units)} units")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    reserved = torch.cuda.max_memory_reserved() if cuda else 0

    # ---- the check (on the program's freed card), then the metrics
    if cuda:
        torch.cuda.empty_cache()
    verdict = driver.check(run)
    if after is not None:
        after(run, driver)
    out_metrics = {}
    for mname, (entry, mod) in metrics.items():
        v = mod.read(run)
        if v is not None:
            out_metrics[mname] = {"value": float(v), "unit": entry["unit"]}

    card = dev.card_power() if cuda else "cpu"
    log(f"[portbench] card {card}; peak allocated {peak} B, reserved {reserved} B")
    device_obj = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name() if cuda else "cpu",
                  "count": 1 if cuda else 0, "memory_peak_bytes": int(peak)}
    line = {"correct": verdict.correct, "attempted": verdict.attempted, "failed": verdict.failed,
            "metrics": out_metrics, "device": device_obj}
    if trace and run.trace_summary is not None:
        ts = run.trace_summary
        device_obj.update(busy_s=ts.busy_s, window_s=ts.window_s)
        line["breakdown"] = {"device_ops": ts.device_ops, "idle_gaps": ts.idle_gaps}
        log(f"[portbench] traced unit: {ts.records} device records, busy {ts.busy_s} s of {ts.window_s} s; "
            f"first record {ts.first_s} s after the unit's start, last {ts.last_s} s before its end")
    log(f"[portbench] correct {verdict.correct}: attempted {verdict.attempted}, failed {verdict.failed}")
    # the numbers compared, each beside its limit: the last lines on
    # standard error, and the last key of the result line
    for n in verdict.numbers:
        log(f"[portbench] compared {n.name} = {n.value!r}, limit {n.limit!r}: {'ok' if n.ok else 'FAILED'}")
    line["compared"] = {n.name: {"value": n.value, "limit": n.limit, "ok": n.ok} for n in verdict.numbers}
    return line
