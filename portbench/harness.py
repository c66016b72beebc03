"""One run of one cell: find its configuration, traffic mix, driver, limits
and per-layer readers by name, set up, measure the window, check the
output against the reference, and print the result line.

Everything a cell needs is looked up from the names in ``BENCHMARK.json``:

    portbench/configs/<config>.json     the configuration as it is run
    portbench/reference/family_<architecture>.py
                                        the plain reference of the
                                        configuration's model family
    portbench/traffic/<traffic>.json    the mix; names its driver
    portbench/drivers/<driver>.py       the general driver of that mix
    portbench/limits/<workload>.json    the limits ``correct`` is held to
    portbench/metrics/<metric>.py       one reader per per-layer metric

so a later cell, configuration, model family, mix or metric is new files
and new entries only.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import tracing

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "meanflow_audio_codec_tpu")


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: dict, kind: str) -> list[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) this cell
    reports."""
    name = cell["name"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    reported = {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m or name in m["workloads"]}
    if kind == "end_to_end":
        return [e2e[n] for n in e2e if n in reported]
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def forbidden_modules() -> list[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclass
class Run:
    """What a run knows, handed to the driver and to the metric readers."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    peaks: dict
    spans: tracing.Spans = field(default_factory=tracing.Spans)
    window: dict = field(default_factory=dict)
    device_trace: tracing.DeviceTrace | None = None
    #: a control in the program's place (calibration only): "fp8" and "half",
    #: the reference in float8 or over half of each batch (training);
    #: "int8", the program's own W8A8 decoder (serving)
    control: str | None = None


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up by name
    spec.loader.exec_module(module)
    return module


def _reader(name: str):
    return _load(BENCH_DIR / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


_FAMILIES: dict[Path, object] = {}


def family(config: dict):
    """The reference module of a v2 config's model family, by the name of
    its ``model.architecture``; loaded once per file."""
    name = config["model"]["architecture"]
    path = BENCH_DIR / "reference" / f"family_{name}.py"
    if not path.exists():
        raise SystemExit(f"no reference of the model family {name!r}: {path} is missing")
    if path not in _FAMILIES:
        _FAMILIES[path] = _load(path, f"portbench_family_{name}")
    return _FAMILIES[path]


def per_layer(run: Run, wanted: list[dict]) -> dict:
    out = {}
    for metric in wanted:
        value = _reader(metric["name"])(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number that has a limit, held to it (``value <= limit``); a
    limit with no number, or a number that is not finite, fails."""
    compared, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok &= good
        compared[name] = {"value": value, "limit": limit}
    return ok and bool(limits), compared


@contextlib.contextmanager
def float32_products():
    """TF32 off while the reference runs, torch's defaults restored after:
    the program's set-up and window run as its users run it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def card(workload_chips: int) -> tuple[torch.device, str] | None:
    """The first card and its name, or None (said why) when the machine
    lacks the cards the cell asks for or their peaks are unknown."""
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < workload_chips:
        say(f"the cell needs {workload_chips} CUDA device(s); found {found}")
        return None
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    from portbench.work import PEAKS

    if kind not in PEAKS:
        say(f"no peaks known for {kind!r}")
        return None
    say(f"device {kind} x{found}")
    return device, kind


def execute(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
            t_start: float, device: torch.device, kind: str, peaks: dict,
            control: str | None = None) -> tuple[dict, dict]:
    """Set up, measure, check; returns (the result line, every number the
    check read). ``device`` may be the CPU only in tests."""
    cell = find_cell(bench, workload)
    config = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits_path = BENCH_DIR / "limits" / f"{workload}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() else {}
    driver_mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    run = Run(cell, config, traffic, seed, seconds, trace, device, peaks,
              control=control)
    driver = driver_mod.Driver(run)
    cuda = device.type == "cuda"

    say(f"set-up: {time.perf_counter() - t_start:.3f} s to the driver")
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    say(f"set-up: {setup_s:.3f} s in all")
    # no collector pauses inside the windows; traced, the first half with
    # the spans alone (the times the readers take), the second under the
    # profiler (the device's activity)
    gc.collect()
    gc.disable()
    try:
        run.window = driver.window(seconds / 2 if trace else seconds)
        attempted, failed = run.window["attempted"], run.window["failed"]
        if trace:
            recorder = tracing.DeviceRecorder(device)
            recorder.start()
            traced = driver.window(seconds / 2)
            run.device_trace = recorder.stop(traced["t0_ns"], traced["t1_ns"])
            attempted += traced["attempted"]
            failed += traced["failed"]
    finally:
        gc.enable()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.free_program()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    try:
        with float32_products():
            numbers = driver.check()
    except Exception:  # a check that cannot finish judges the run wrong
        say(traceback.format_exc())
        numbers = {}
    say(f"check: {time.perf_counter() - t_check:.3f} s")
    correct, compared = judge(numbers, limits)
    for name, value in numbers.items():
        if name not in limits:
            say(f"not compared: {name} {value!r}")

    if trace:
        metrics = per_layer(run, metrics_for(bench, cell, "per_layer"))
    else:
        metrics = {}
        e2e = dict(run.window["end_to_end"], setup_s=setup_s)
        for metric in metrics_for(bench, cell, "end_to_end"):
            metrics[metric["name"]] = {"value": e2e[metric["name"]],
                                       "unit": metric["unit"]}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu", "kind": kind, "count": cell["chips"],
                         "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = run.device_trace.busy_s
        result["device"]["window_s"] = run.device_trace.window_s
        result["breakdown"] = tracing.breakdown(run.device_trace, run.spans)
    result["compared"] = compared
    return result, numbers


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float) -> int:
    """The command's run: on the card, or an exit code other than 0."""
    found = card(find_cell(bench, workload)["chips"])
    if found is None:
        return 3
    device, kind = found
    from portbench.work import PEAKS

    result, _ = execute(bench, workload, seed, seconds, trace, t_start,
                        device, kind, PEAKS[kind])
    leaked = forbidden_modules()
    if leaked:
        say(f"modules that may not load in a run: {', '.join(leaked)}")
        return 4
    for name, item in result["compared"].items():
        say(f"compared {name}: {item['value']!r} limit {item['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
