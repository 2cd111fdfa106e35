"""What the program records itself: the spans and counter increments of
the port's recorder (metagenomics_tpu_torch/utils/timing.py), read by step
of the window.

A span or counter increment belongs to step i where its start (a count's
time) lies in run.steps[i]; a reader's value is the mean over the window's
steps, a step without one counting 0.  A reader finds nothing
(LookupError) where the program has no recorder, where the recorder
dropped a record inside the window, or where the window's steps hold
nothing of what it reads.
"""

import bisect

from omegabench.readers import window_steps

# the spans that drive a step and name no work of their own: their self
# time is what no program span names
OUTER_SPANS = ("main", "assembler.run", "buildOverlapGraphFromHashTable")


def _ns(t):
    """A host perf_counter() reading in perf_counter_ns() units."""
    return int(round(t * 1e9))


class Window:
    """The recorder's records, those of the window's steps by step."""

    def __init__(self, run):
        steps = window_steps(run)
        try:
            from metagenomics_tpu_torch.utils import timing
        except ImportError as exc:
            raise LookupError("the program cannot be imported: %s" % exc)
        rec = getattr(timing, "recorder", None)
        if rec is None:
            raise LookupError("the program records no spans")
        w0 = _ns(run.window_t0)
        records = rec.snapshot(since=w0)
        if rec.dropped and rec.dropped_until >= w0:
            raise LookupError("the recorder dropped %d records, some inside "
                              "the window" % rec.dropped)
        self.bounds = [(_ns(a), _ns(b)) for a, b in steps]
        starts = [a for a, _ in self.bounds]
        self.spans = [[] for _ in steps]
        self.counts = [[] for _ in steps]
        self.by_id = {}
        self.child_ns = {}               # span id -> its children's ns
        for r in records:
            is_span = isinstance(r, timing.Span)
            if is_span:
                self.by_id[r.id] = r
                self.child_ns[r.parent] = (self.child_ns.get(r.parent, 0)
                                           + r.end - r.start)
            t = r.start if is_span else r.t
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < self.bounds[i][1]:
                (self.spans if is_span else self.counts)[i].append(r)

    def mean(self, per_step, what):
        """Mean over the steps of per_step(step's spans, step's counts),
        which returns None where the step holds none of `what`."""
        vals = [per_step(s, c) for s, c in zip(self.spans, self.counts)]
        if all(v is None for v in vals):
            raise LookupError("no %s in the window's steps" % what)
        return sum(v or 0 for v in vals) / len(vals)

    def inside(self, r, names):
        """Whether an ancestor of span r is named in `names`."""
        p = self.by_id.get(r.parent)
        while p is not None:
            if p.name in names:
                return True
            p = self.by_id.get(p.parent)
        return False


def span_s(run, names, outside=()):
    """Seconds a step of the spans named in `names`, leaving out those
    inside another of them (counted once, in it) or inside a span named
    in `outside`."""
    w = Window(run)
    skip = set(names) | set(outside)

    def step(spans, counts):
        d = [r.end - r.start for r in spans
             if r.name in names and not w.inside(r, skip)]
        return sum(d) / 1e9 if d else None
    return w.mean(step, "span %s" % "/".join(names))


def count_sum(run, name):
    """Sum a step of the increments of counter `name`."""
    return Window(run).mean(
        lambda spans, counts: sum(c.n for c in counts if c.name == name)
        if any(c.name == name for c in counts) else None,
        "count %s" % name)


def self_s(run, names):
    """Seconds a step of the spans named in `names` less the time their
    child spans cover."""
    w = Window(run)

    def step(spans, counts):
        d = [r.end - r.start - w.child_ns.get(r.id, 0) for r in spans
             if r.name in names]
        return sum(d) / 1e9 if d else None
    return w.mean(step, "span %s" % "/".join(names))
