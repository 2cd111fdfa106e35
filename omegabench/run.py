"""Run one cell of the benchmark once and print its result line.

    python3 omegabench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
    (or python3 -m omegabench ... from the checkout's root)

The cell's sample is made from the seed and written to a fresh directory
under TMPDIR; the program loads it, runs one warm step (set-up ends there),
then runs steps back to back for --seconds.  On a card the window is
profiled (the card's busy time is an end-to-end metric); with --trace 1
spans are taken around the program's layers too, and the line carries the
cell's per-layer metrics; with --trace 0, its end-to-end metrics.  Once
the window has closed, the program's outputs are compared with the plain
reference (check.py), and each number compared is printed beside its
limit: as the last lines on standard error, and last in the
result line.  The result is the last line of standard output.

Exits non-zero, printing no result, where CUDA is unavailable or has fewer
cards than the cell asks for, or where a module of jax, jaxlib, flax or
metagenomics_tpu (the JAX package) is loaded once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, sys.path[0] is this directory: put the checkout's root
# there instead, so that no file here shadows a module of the same name
if sys.path and os.path.abspath(sys.path[0] or os.curdir) == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "metagenomics_tpu")
NAME_CHARS = 160        # a device op's name in the breakdown, cut to this


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None):
    """Top-level names, compared whole, of loaded modules that the
    benchmark must not load."""
    names = {m.split(".")[0] for m in (modules or list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


def card_label():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as exc:
        return "nvidia-smi unavailable (%s)" % exc
    return out.strip().splitlines()[0] if out.strip() else "unknown"


class Run:
    """What the metric readers read: the window's steps (host clock), the
    probe's spans and captures, the device trace, the assemblies' phases."""

    def __init__(self, config, workdir, probe):
        self.config = config
        self.workdir = workdir
        self.probe = probe
        self.fasta = []
        self.units = 0
        self.steps = []
        self.window_t0 = None
        self.device_trace = None
        self.phases = None


def read_metrics(cell, entries, run, log):
    out = {}
    for m in entries:
        try:
            value = cell.reader(m["name"])(run)
        except LookupError as exc:
            log("metric %s: none (%s)" % (m["name"], exc))
            continue
        except Exception as exc:          # a reader never ends the run
            log("metric %s: none (reader failed: %r)" % (m["name"], exc))
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def log_spans(probe, n_steps, log):
    """Mean seconds a step of each host span of the window's steps."""
    tot = {}
    for name, step, a, b in probe.spans:
        if 0 <= step < n_steps:
            tot[name] = tot.get(name, 0.0) + b - a
    if n_steps:
        log("host spans, mean s a step: %s" % ", ".join(
            "%s %.4f" % (n, t / n_steps) for n, t in sorted(tot.items())))


def log_stages(run, log):
    """Each device stage's least bytes beside its mean device time a
    construction, where the run traced the device pipeline."""
    from omegabench import readers, stages
    probe = run.probe
    if probe.pipeline is None or probe.last_stream is None:
        return
    counts = probe.last_stream[0]
    dims = dict(probe.pipeline,
                survivors=int(counts[probe.pipeline["row0"]:].sum()))
    ms = {}
    for name in ("setup_kernel", "probe_join", "emit_verify"):
        try:
            ms[name] = readers.device_ms(run, name)
        except LookupError:
            pass
    for line in stages.stage_lines(dims, ms):
        log(line)


def run_cell(cell, seed, seconds, trace, device, t_start, log=log):
    """Set up, warm, measure and check one run of `cell` on `device`;
    returns (result dict, checks)."""
    import torch
    from omegabench import check, generator, tracing
    from omegabench.probe import Probe

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    workdir = tempfile.mkdtemp(prefix="omegabench-")
    probe = Probe(bool(trace))
    run = Run(cell.config, workdir, probe)
    try:
        t = time.perf_counter()
        run.fasta, stats = generator.write_sample(cell.config, cell.traffic,
                                                  seed, workdir)
        log("sample: %s (%.3f s)" % (stats, time.perf_counter() - t))
        probe.install()
        t = time.perf_counter()
        entry = cell.entry.make(run)
        run.units = entry.units
        log("loaded: %d units a step (%.3f s)"
            % (run.units, time.perf_counter() - t))
        failed = []

        def attempt(i):
            """One step; a step that raises is counted as failed and the
            run goes on (the check then sees what it left)."""
            probe.begin_step(i)
            try:
                entry.step()
                sync()
                return True
            except Exception:
                failed.append(i)
                log("step %d failed:\n%s" % (i, traceback.format_exc()))
                return False
            finally:
                probe.end_step()

        t = time.perf_counter()
        attempt(-1)
        if hasattr(entry, "forget_logs"):
            entry.forget_logs()
        log("warm step: %.3f s, engine %s" % (time.perf_counter() - t,
                                               entry.engine()))
        setup_s = time.perf_counter() - t_start

        # the card's busy time, an end-to-end metric, comes from the
        # profiler's trace: every run on a card profiles its window
        with tracing.profiled(bool(trace) or cuda, workdir, device) as prof:
            run.window_t0 = t0 = time.perf_counter()
            attempted = 0
            while time.perf_counter() - t0 < seconds:
                i = len(run.steps)
                a = time.perf_counter()
                ok = attempt(i)
                b = time.perf_counter()
                attempted += 1
                if ok:
                    run.steps.append((a, b))
                    if trace:
                        probe.spans.append(("step", i, a, b))
        log("window: %d steps completed, %d failed, in %.3f s: %s" % (
            len(run.steps), len(failed), time.perf_counter() - t0,
            [round(b - a, 6) for a, b in run.steps]))
        if trace:
            log_spans(probe, len(run.steps), log)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        engine = entry.engine()
        if hasattr(entry, "phases"):
            run.phases = entry.phases()
        if "trace" in prof:
            try:
                run.device_trace = tracing.DeviceTrace(prof["trace"])
            except LookupError as exc:
                log("device trace: none (%s)" % exc)
        try:
            outputs = entry.outputs()
        except Exception:
            log("outputs: none readable:\n%s" % traceback.format_exc())
            outputs = {}
        outputs["stream"] = probe.last_stream
        probe.uninstall()
        entry.release()
        del entry
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t = time.perf_counter()
        checks = check.check_outputs(outputs, run.fasta, cell.config,
                                     cell.traffic, seed, log)
        del outputs
        log("reference check: %.3f s" % (time.perf_counter() - t))

        result = {"correct": not failed and all(c.ok for c in checks),
                  "attempted": attempted, "failed": len(failed)}
        if trace:
            metrics = read_metrics(cell, cell.per_layer, run, log)
        else:
            metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
            metrics.update(read_metrics(
                cell, [m for m in cell.end_to_end if m["name"] != "setup_s"],
                run, log))
        result["metrics"] = metrics
        dev = {"platform": "gpu" if cuda else device.type,
               "kind": torch.cuda.get_device_name(device) if cuda
               else device.type,
               "count": cell.chips, "memory_peak_bytes": int(peak)}
        log("engine: %s; memory_peak_bytes %d" % (engine, peak))
        result["device"] = dev
        if cuda and trace:
            log_stages(run, log)
        if trace and run.device_trace is not None:
            dt = run.device_trace
            busy, gaps = dt.busy()
            dev.update(busy_s=busy, window_s=dt.window_s)
            result["breakdown"] = {
                "device_ops": [[n[:NAME_CHARS], s]
                               for n, s in dt.top_ops(10)],
                "idle_gaps": tracing.name_gaps(gaps, probe.spans, t0, dt.t0)}
        result["checks"] = {c.name: c.record() for c in checks}
        return result, checks
    finally:
        probe.uninstall()
        shutil.rmtree(workdir, ignore_errors=True)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from omegabench import layout
    cell = layout.Cell(args.workload, layout.benchmark())
    import torch
    if not torch.cuda.is_available():
        log("CUDA is not available: the benchmark runs on a CUDA card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log("the cell asks for %d cards, %d are visible"
            % (cell.chips, torch.cuda.device_count()))
        return 2
    log("card: %s; torch %s, CUDA %s" % (card_label(), torch.__version__,
                                         torch.version.cuda))
    result, checks = run_cell(cell, args.seed, args.seconds, args.trace,
                              torch.device("cuda", 0), T_PROCESS)
    found = forbidden_modules()
    if found:
        log("loaded, and must not be: %s" % ", ".join(found))
        return 3
    for c in checks:
        log("check %s: %s (limit %s, of %s)" % (c.name, c.value, c.limit,
                                                c.of))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
