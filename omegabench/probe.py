"""Spans and captures from the benchmark's side, around calls into the
program's layers (the program itself is not changed).

Always on: the capture of the last canonical overlap stream handed to the
native replay, which the correctness check reads.  In a traced run also:
host-clock spans (cpu_scan, replay, ingest, construct, mate_pairs,
materialize, flow, simplify, matepair_merge, scaffold, resolve),
CUDA-event spans (setup_kernel, probe_join, emit_verify), the device
pipeline's shapes and the window-hash launches' bytes.
"""

import functools
import time

import numpy as np


class Probe:
    def __init__(self, traced):
        self.traced = traced
        self.step = -1
        self.spans = []          # (name, step, t0, t1) host perf_counter
        self.events = []         # (name, step, start, stop) CUDA events
        self.device_ms = []      # (name, step, ms)
        self.launches = []       # (kernel, step, least bytes)
        self.pending = []        # (kernel, step, starts, hash_len, nbytes)
        self.last_stream = None  # (counts, words, off_bits) of the replay
        self.pipeline = None     # shapes of the last device pipeline
        self._undo = []

    # ------------------------------------------------------------ install

    def install(self):
        from metagenomics_tpu_torch import assembler, native
        from metagenomics_tpu_torch.ops import device_overlap as dov
        self._wrap(native, "build_graph_stream_canon_words",
                   self._replay(native.build_graph_stream_canon_words))
        if not self.traced:
            return
        self._wrap(native, "scan_canon",
                   self._host("cpu_scan", native.scan_canon))
        self._wrap(assembler, "Dataset",
                   self._host("ingest", assembler.Dataset))
        self._wrap(assembler.Assembler, "_build",
                   self._host("construct", assembler.Assembler._build))
        from metagenomics_tpu_torch import dataset
        from metagenomics_tpu_torch.graph import (build, flow, matepair,
                                                  scaffold, simplify)
        for obj, name, span in (
                (dataset.Dataset, "read_mate_pairs_from_file", "mate_pairs"),
                (build.BuildMixin, "_load_native_result", "materialize"),
                (flow.FlowMixin, "calculate_flow", "flow"),
                (simplify.SimplifyMixin, "simplify_graph", "simplify"),
                (matepair.MatePairMixin,
                 "find_support_by_matepairs_and_merge", "matepair_merge"),
                (scaffold.ScaffoldMixin, "scaffolder", "scaffold"),
                (scaffold.ScaffoldMixin, "resolve_nodes", "resolve")):
            self._wrap(obj, name, self._host(span, getattr(obj, name)))
        self._wrap(dov, "_setup_kernel",
                   self._device("setup_kernel", dov._setup_kernel))
        self._wrap(dov, "_probe_join",
                   self._device("probe_join", dov._probe_join))
        self._wrap(dov.DeviceOverlapPipeline, "_probe",
                   self._shapes(dov.DeviceOverlapPipeline._probe))
        self._wrap(dov, "_emit2", self._device("emit_verify", dov._emit2))
        self._wrap(dov, "_cont_canon",
                   self._device("emit_verify", dov._cont_canon))
        self._wrap(dov, "window_hashes", self._hash(dov.window_hashes))
        self._wrap(dov, "window_hashes_at",
                   self._hash_at(dov.window_hashes_at))

    def uninstall(self):
        for obj, name, old in reversed(self._undo):
            setattr(obj, name, old)
        self._undo = []

    def _wrap(self, obj, name, new):
        self._undo.append((obj, name, obj.__dict__[name]))
        setattr(obj, name, new)

    # ------------------------------------------------------------ steps

    def begin_step(self, i):
        self.step = i

    def end_step(self):
        """After the step's synchronize: CUDA-event spans to ms, and the
        window-hash-at launches' window bytes from their starts."""
        for name, step, start, stop in self.events:
            self.device_ms.append((name, step, start.elapsed_time(stop)))
        self.events = []
        for kernel, step, starts, hash_len, nbytes in self.pending:
            s = np.sort(starts.cpu().numpy(), axis=1)
            cover = hash_len + np.minimum(np.diff(s, axis=1), hash_len)
            self.launches.append((kernel, step, nbytes + int(cover.sum())))
        self.pending = []

    # ------------------------------------------------------------ wrappers

    def _replay(self, fn):
        @functools.wraps(fn)
        def replay(lengths, counts, words, off_bits, *a, **k):
            self.last_stream = (counts, words, off_bits)
            t0 = time.perf_counter()
            try:
                return fn(lengths, counts, words, off_bits, *a, **k)
            finally:
                if self.traced:
                    self.spans.append(("replay", self.step, t0,
                                       time.perf_counter()))
        return replay

    def _host(self, name, fn):
        @functools.wraps(fn)
        def span(*a, **k):
            step = self.step
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.spans.append((name, step, t0, time.perf_counter()))
        return span

    def _device(self, name, fn):
        import torch

        @functools.wraps(fn)
        def span(*a, **k):
            dev = next(x.device for x in a if isinstance(x, torch.Tensor))
            if dev.type != "cuda":
                t0 = time.perf_counter()
                out = fn(*a, **k)
                self.device_ms.append(
                    (name, self.step, 1e3 * (time.perf_counter() - t0)))
                return out
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            stop.record()
            self.events.append((name, self.step, start, stop))
            return out
        return span

    def _shapes(self, fn):
        @functools.wraps(fn)
        def probe(pipeline):
            out = fn(pipeline)
            self.pipeline = {"n1": int(pipeline.hf.shape[0]),
                             "row0": pipeline.row0, "w": pipeline.w,
                             "npos": pipeline.npos,
                             "h_total": int(pipeline.h_total)}
            return out
        return probe

    def _hash(self, fn):
        @functools.wraps(fn)
        def hashes(codes, hash_len):
            out = fn(codes, hash_len)
            # codes read once, hashes written once at the output's width
            self.launches.append(
                ("window_hash", self.step,
                 codes.numel() * codes.element_size()
                 + out.numel() * out.element_size()))
            return out
        return hashes

    def _hash_at(self, fn):
        @functools.wraps(fn)
        def hashes_at(codes, hash_len, starts, bad=None):
            out = fn(codes, hash_len, starts, bad)
            # the bytes the windows cover read once (added in end_step),
            # the starts read once, the hashes written once
            self.pending.append(
                ("window_hash_at", self.step, starts, hash_len,
                 starts.numel() * starts.element_size()
                 + out.numel() * out.element_size()))
            return out
        return hashes_at
