"""Collectives of the sharded pipeline, and their byte ledger.

Port of metagenomics_tpu/parallel/collectives.py (the ledger) plus the two
backends that move data between the shards of a (dp, ix) mesh, behind one
interface.  Every operation takes and returns a dict {(d, i): tensor} over
the shards this process holds (`local`):

* InProcess: every shard of the mesh lives in this process (on one device
  repeated, or on several); each operation works on all shards at once,
  and tensors move with .to(device) of the receiving shard;
* Distributed: one shard per rank of an initialized torch.distributed
  world (rank = d * ix + i), one process group per dp row (the ix axis)
  and one per ix column (the dp axis); NCCL on cards, gloo on the CPU.

Operations (the reference's shard_map collectives):
  all_gather(xs, axis)  -- concatenation along dim 0 in axis order
  all_to_all(xs, axis)  -- block s of shard t becomes block t of shard s
  ppermute(xs)          -- the dp ring: shard d receives shard d+1's
                           tensor (perm [(x, (x-1) % D)])
  psum(xs, axis)        -- int32 sum over the axis
  host(xs, keys)        -- numpy copies of the given shards on the host
                           (under torch.distributed, all-gathered to every
                           rank; not a ledger collective: the reference's
                           host reads are not either)

Every payload crosses as a 32-bit tensor.  In the sharded pipeline every
int64 tensor holds a uint32 value; it travels as its int32 bit pattern
and is widened and masked with MASK32 on arrival, so the bytes equal the
reference's and NCCL, which has no uint32, carries them.

The ledger counts at call time: each collective call is charged the
payload of ONE shard, as the reference's trace-time record() is, so
report() gives the reference's payload_bytes per (phase, op, axis,
axis_size) for the same data and split."""

import contextlib
import warnings
from collections import defaultdict

import torch

MASK32 = 0xFFFFFFFF

# NVIDIA's data sheet, H100 SXM: NVLink 900 GB/s per card, 450 GB/s each way
NVLINK_BYTES_PER_S = 4.5e11


class CollectiveLedger:
    def __init__(self):
        self.reset()

    def reset(self):
        # (phase, op, axis, axis_size) -> accumulated payload bytes
        self.totals = defaultdict(int)
        self.calls = defaultdict(int)          # phase -> invocation count
        self._last_per_call = {}
        self._events = None

    @contextlib.contextmanager
    def phase(self, name):
        """Wrap ONE stage invocation: record() calls during the body are
        charged to `name` on exit."""
        prev = self._events
        self._events = []
        try:
            yield
        finally:
            per_call = defaultdict(int)
            for op, axis, asize, nbytes in self._events:
                per_call[(op, axis, asize)] += nbytes
            for key, nbytes in per_call.items():
                self.totals[(name,) + key] += nbytes
                self._last_per_call[(name,) + key] = nbytes
            self.calls[name] += 1
            self._events = prev

    def record(self, op, axis, axis_size, *tensors):
        """Log the payload bytes of one shard's `tensors` for the current
        phase invocation (a no-op outside a phase)."""
        if self._events is None:
            return
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        self._events.append((op, axis, axis_size, nbytes))

    # ----------------------------------------------------------- reporting

    _WIRE = {
        "all_gather": lambda b, a: b * (a - 1),         # out buffer = a*b
        "all_to_all": lambda b, a: b * (a - 1) / a,
        "ppermute": lambda b, a: b,
        "psum": lambda b, a: 2 * b * (a - 1) / a,
    }

    def report(self, link_bytes_per_s=NVLINK_BYTES_PER_S):
        """Per-phase collective totals + a modeled link transfer time (by
        default at the H100 SXM's NVLink rate, each way)."""
        phases = {}
        for (phase, op, axis, asize), total in sorted(self.totals.items()):
            calls = self.calls.get(phase, 1)
            wire = self._WIRE[op](total, max(asize, 1))
            rec = phases.setdefault(phase, {
                "invocations": calls, "collectives": [],
                "payload_bytes": 0, "wire_bytes": 0})
            rec["collectives"].append({
                "op": op, "axis": axis, "axis_size": asize,
                "payload_bytes_per_call": self._last_per_call.get(
                    (phase, op, axis, asize), 0),
                "payload_bytes": total, "wire_bytes": int(wire)})
            rec["payload_bytes"] += total
            rec["wire_bytes"] += int(wire)
        total_wire = sum(p["wire_bytes"] for p in phases.values())
        return {
            "phases": phases,
            "total_payload_bytes": sum(p["payload_bytes"]
                                       for p in phases.values()),
            "total_wire_bytes": total_wire,
            "model": {
                "nvlink_bytes_per_s": link_bytes_per_s,
                "projected_nvlink_seconds": total_wire / link_bytes_per_s,
                "assumptions": "ring all_gather/psum; per-device wire "
                               "bytes; no overlap with compute",
            },
        }


LEDGER = CollectiveLedger()


def to_wire(x):
    """The 32-bit payload of x: int64 (uint32 values) as int32 bits."""
    if x.dtype == torch.int64:
        return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)
    return x


def from_wire(x, dtype):
    """Inverse of to_wire for a tensor that was `dtype` before it crossed."""
    if dtype == torch.int64:
        return x.to(torch.int64) & MASK32
    return x


class _Comm:
    def __init__(self, dp, ix):
        self.dp, self.ix = dp, ix

    def axis_size(self, axis):
        return self.dp if axis == "dp" else self.ix

    def members(self, key, axis):
        """The shards of key's group along `axis`, in axis order."""
        d, i = key
        if axis == "dp":
            return [(k, i) for k in range(self.dp)]
        return [(d, k) for k in range(self.ix)]

    def _wire(self, op, axis, xs):
        """xs as 32-bit payloads, charged to the ledger once (one shard)."""
        wire = {k: to_wire(v) for k, v in xs.items()}
        LEDGER.record(op, axis, self.axis_size(axis), next(iter(
            wire.values())))
        return wire


class InProcess(_Comm):
    """Every shard of the mesh in this process; shard (d, i) on
    devices[d * ix + i]."""

    def __init__(self, dp, ix, devices):
        super().__init__(dp, ix)
        self.local = [(d, i) for d in range(dp) for i in range(ix)]
        self.devices = {k: devices[k[0] * ix + k[1]] for k in self.local}

    def all_gather(self, xs, axis):
        dtype = next(iter(xs.values())).dtype
        wire = self._wire("all_gather", axis, xs)
        out, made = {}, {}
        for key in self.local:
            group = tuple(self.members(key, axis))
            dev = self.devices[key]
            # the shards of one group on one device share the result
            if (group, dev) not in made:
                made[group, dev] = from_wire(
                    torch.cat([wire[m].to(dev) for m in group]), dtype)
            out[key] = made[group, dev]
        return out

    def all_to_all(self, xs, axis):
        dtype = next(iter(xs.values())).dtype
        wire = self._wire("all_to_all", axis, xs)
        out = {}
        for key in self.local:
            group = self.members(key, axis)
            me = group.index(key)
            dev = self.devices[key]
            out[key] = from_wire(torch.stack(
                [wire[m][me].to(dev) for m in group]), dtype)
        return out

    def ppermute(self, xs):
        dtype = next(iter(xs.values())).dtype
        wire = self._wire("ppermute", "dp", xs)
        return {(d, i): from_wire(
            wire[((d + 1) % self.dp, i)].to(self.devices[d, i]), dtype)
            for d, i in self.local}

    def psum(self, xs, axis):
        LEDGER.record("psum", axis, self.axis_size(axis),
                      next(iter(xs.values())))
        out = {}
        for key in self.local:
            dev = self.devices[key]
            out[key] = torch.stack([xs[m].to(dev) for m in self.members(
                key, axis)]).sum(0, dtype=torch.int32)
        return out

    def host(self, xs, keys):
        return {k: xs[k].cpu().numpy() for k in keys}


class Distributed(_Comm):
    """One shard per rank of the initialized torch.distributed world:
    rank r holds shard (r // ix, r % ix) on `device`."""

    def __init__(self, dp, ix, device):
        import torch.distributed as dist
        super().__init__(dp, ix)
        self.dist = dist
        rank = dist.get_rank()
        self.key = (rank // ix, rank % ix)
        self.local = [self.key]
        self.device = device
        # every rank creates every group, in the same order; new_group
        # orders a group by global rank, which is its axis order here
        self.groups = {}
        for d in range(dp):
            g = dist.new_group([d * ix + i for i in range(ix)])
            if d == self.key[0]:
                self.groups["ix"] = g
        for i in range(ix):
            g = dist.new_group([d * ix + i for d in range(dp)])
            if i == self.key[1]:
                self.groups["dp"] = g

    def _gather_into(self, w, group):
        out = torch.empty((self.dist.get_world_size(group) * w.shape[0],)
                          + tuple(w.shape[1:]), dtype=w.dtype,
                          device=w.device)
        # torch 2.13 names this all_gather_single; the card's 2.11 has only
        # the old name, which both accept
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            self.dist.all_gather_into_tensor(out, w.contiguous(),
                                             group=group)
        return out

    def all_gather(self, xs, axis):
        x = xs[self.key]
        w = self._wire("all_gather", axis, xs)[self.key]
        return {self.key: from_wire(self._gather_into(w, self.groups[axis]),
                                    x.dtype)}

    def all_to_all(self, xs, axis):
        x = xs[self.key]
        w = self._wire("all_to_all", axis, xs)[self.key].contiguous()
        out = torch.empty_like(w)
        self.dist.all_to_all_single(out, w, group=self.groups[axis])
        return {self.key: from_wire(out, x.dtype)}

    def ppermute(self, xs):
        x = xs[self.key]
        w = self._wire("ppermute", "dp", xs)[self.key].contiguous()
        d, i = self.key
        to = ((d - 1) % self.dp) * self.ix + i
        frm = ((d + 1) % self.dp) * self.ix + i
        out = torch.empty_like(w)
        # send and receive in one batch, so that no rank of the ring waits
        # on its neighbour's send
        reqs = self.dist.batch_isend_irecv([
            self.dist.P2POp(self.dist.isend, w, to),
            self.dist.P2POp(self.dist.irecv, out, frm)])
        for r in reqs:
            r.wait()
        return {self.key: from_wire(out, x.dtype)}

    def psum(self, xs, axis):
        x = xs[self.key]
        LEDGER.record("psum", axis, self.axis_size(axis), x)
        y = x.to(torch.int32).reshape(-1).clone()
        self.dist.all_reduce(y, op=self.dist.ReduceOp.SUM,
                             group=self.groups[axis])
        return {self.key: y.reshape(x.shape)}

    def host(self, xs, keys):
        x = xs[self.key]
        w = to_wire(x).reshape((1,) + tuple(x.shape))
        full = from_wire(self._gather_into(w, None), x.dtype).cpu().numpy()
        return {k: full[k[0] * self.ix + k[1]] for k in keys}
