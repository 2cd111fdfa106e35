"""The device pipeline's two segment fills, run end and slot owner, held to
the one-block running scans they replace (cummin for the key run's upper
bound in the sort-merge join, scatter-then-cummax for the bucket that owns
each expansion slot), every position compared, slots past the live total
included.  Then the whole device, hybrid and sharded pipelines run with
every cummin/cummax of torch made to raise, and still equal the JAX
package's output.  Exact equality throughout."""

import os

import numpy as np
import pytest
import torch

# one torch thread: the suite runs several workers side by side
torch.set_num_threads(1)

from metagenomics_tpu.dataset import Dataset
from metagenomics_tpu.ops import device_overlap as jdo
from metagenomics_tpu.parallel.mesh import make_mesh as jmesh
from metagenomics_tpu.parallel.sharded import ShardedOverlapPipeline as JSP
from metagenomics_tpu_torch.ops import device_overlap as tdo
from metagenomics_tpu_torch.parallel.mesh import make_mesh as tmesh
from metagenomics_tpu_torch.parallel.sharded import \
    ShardedOverlapPipeline as TSP

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "golden", "data")
CPU = torch.device("cpu")
I32, I64 = torch.int32, torch.int64
U32_MAX = 0xFFFFFFFF


def _quiet(*a, **k):
    pass


# ------------------------------------------------------------------ oracles

def _owner_by_scan(cnt, cap):
    """Scatter each nonzero bucket's id to its start slot, then a running
    max over the cap slots (the form _slot_owner replaces)."""
    cum = torch.cumsum(cnt, dim=0, dtype=I32)
    starts = cum - cnt
    dest = torch.where(cnt > 0, starts, cap)
    seed = tdo._scatter_drop(torch.zeros(cap, dtype=I32), dest,
                             torch.arange(cnt.shape[0], dtype=I32), "amax")
    return seed.cummax(0).values.to(I64)


def _run_end_by_scan(kv, u):
    """u at the last position of each run of equal keys, carried back over
    the run by a reversed running min (the form the join replaces)."""
    is_last = torch.cat([kv[1:] != kv[:-1], torch.ones(1, dtype=torch.bool)])
    return torch.where(is_last, u, 0x7FFFFFFF).flip(0).cummin(0).values \
        .flip(0)


def _probe_join_by_scan(hf, lengths, sk, hash_len, sum_block):
    """_probe_join with the run end taken by the scan."""
    n1, npos = hf.shape
    q_total = n1 * npos
    m = sk.shape[0]
    q = hf.reshape(-1)
    jj = torch.arange(npos, dtype=I32)[None, :]
    valid = ((jj >= 1) & (jj < (lengths[:, None] - hash_len))).reshape(-1)
    pq = torch.arange(q_total, dtype=I64) | torch.where(valid, 0, 0x40000000)
    pi = torch.arange(m, dtype=I64) | 0x80000000
    kv, perm = torch.sort(torch.cat([q, sk]), stable=True)
    pv = torch.cat([pq, pi])[perm]
    tag = (pv >> 31).to(I32)
    u = torch.cumsum(tag, dim=0, dtype=I32)
    cnt = _run_end_by_scan(kv, u) - u
    hit = (tag == 0) & (cnt > 0) & ((pv & 0x40000000) == 0)
    rk, perm = torch.sort(torch.where(hit, pv & 0x3FFFFFFF, tdo.PAD_HASH),
                          stable=True)
    cq = torch.where(hit, cnt, 0)
    parts = torch.nn.functional.pad(cq, (0, -cq.shape[0] % sum_block)) \
        .reshape(-1, sum_block).sum(dim=1, dtype=I32)
    return rk, u[perm], cnt[perm], hit.sum(dtype=I32), parts


def _equal(got, want, what):
    assert got.dtype == want.dtype, "%s: %s != %s" % (what, got.dtype,
                                                      want.dtype)
    np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=what)


# ---------------------------------------------------------- slot owner

def _counts(case):
    """(bucket counts, slot count) of one named case."""
    c = lambda *v: torch.tensor(v, dtype=I32)
    if case == "all_zero":
        return c(0, 0, 0, 0, 0), 16
    if case == "one_bucket_zero":
        return c(0), 4
    if case == "zeros_start_inside_end":
        return c(0, 0, 3, 0, 1, 0, 0, 2, 4, 0, 0), 10
    if case == "one_bucket_spans_all":
        return c(0, 0, 12, 0, 0), 12
    if case == "size_above_total":
        return c(2, 0, 3, 1, 0), 64
    if case == "size_below_total":
        return c(5, 0, 7, 9, 0, 4), 8
    if case == "single_slot":
        return c(0, 1, 0), 1
    seed = int(case.split("_")[1])
    g = torch.Generator().manual_seed(seed)
    n = 1 << 15
    # about a third zero, the rest small with a heavy bucket here and there
    cnt = torch.randint(0, 8, (n,), generator=g, dtype=I32)
    cnt = torch.where(torch.rand(n, generator=g) < 0.33, 0, cnt)
    heavy = torch.rand(n, generator=g) < 0.002
    cnt = torch.where(heavy, cnt * 97, cnt)
    total = int(cnt.sum())
    # 2^16 slots: even seeds run past them, odd ones are cut to fit
    cap = 1 << 16
    if seed % 2:
        cnt = torch.where(torch.cumsum(cnt, 0) <= cap, cnt, 0)
    assert total > 0
    return cnt, cap


@pytest.mark.parametrize("case", [
    "all_zero", "one_bucket_zero", "zeros_start_inside_end",
    "one_bucket_spans_all", "size_above_total", "size_below_total",
    "single_slot", "random_1", "random_2", "random_3", "random_4"])
def test_slot_owner_equals_scan(case):
    cnt, cap = _counts(case)
    cum = torch.cumsum(cnt, dim=0, dtype=I32)
    k = torch.arange(cap, dtype=I32)
    _equal(tdo._slot_owner(cum, k), _owner_by_scan(cnt, cap), case)


# ------------------------------------------------------------------ run end

def _keys(case, g):
    """(query keys, sorted index keys), int64 holding uint32."""
    t = lambda *v: torch.tensor(v, dtype=I64)
    if case == "repeated":
        return t(5, 5, 5, 7, 7, 9, 5), t(5, 5, 7, 7, 7, 9, 9, 9, 9)
    if case == "absent":
        return t(4, 6, 8, 10, 6), t(5, 7, 9)
    if case == "below_and_above":
        return t(1, 2, 100, 200, 50), t(10, 20, 50, 50, 60)
    if case == "extremes":
        return (t(0, U32_MAX, 0, 7, U32_MAX, U32_MAX - 1),
                t(0, 0, 7, U32_MAX - 1, U32_MAX, U32_MAX))
    if case == "no_index_at_extremes":
        return t(0, U32_MAX, 3), t(1, 2, 3, U32_MAX - 1)
    # random over a small alphabet spread over the whole uint32 range
    alphabet = torch.tensor([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001,
                             U32_MAX - 1, U32_MAX], dtype=I64)
    alphabet = torch.cat([alphabet, torch.randint(
        0, 1 << 32, (24,), generator=g, dtype=I64)])
    q = alphabet[torch.randint(0, 32, (4000,), generator=g)]
    sk = alphabet[torch.randint(0, 20, (1500,), generator=g)]
    return q, torch.sort(sk).values


RUN_CASES = ["repeated", "absent", "below_and_above", "extremes",
             "no_index_at_extremes", "random_1", "random_2", "random_3"]


def _seed(case):
    return int(case.split("_")[1]) if case.startswith("random_") else 0


@pytest.mark.parametrize("case", RUN_CASES)
def test_run_end_equals_scan(case):
    q, sk = _keys(case, torch.Generator().manual_seed(_seed(case)))
    kv, perm = torch.sort(torch.cat([q, sk]), stable=True)
    tag = (perm >= q.shape[0]).to(I32)        # 1 at index entries
    u = torch.cumsum(tag, dim=0, dtype=I32)
    got = torch.searchsorted(sk, kv, right=True, out_int32=True)
    _equal(got, _run_end_by_scan(kv, u), case)


@pytest.mark.parametrize("case", RUN_CASES)
def test_probe_join_equals_scan_form(case):
    """The whole join, every returned buffer, against its scan form: the
    keys laid out as window hashes of reads of mixed lengths."""
    g = torch.Generator().manual_seed(_seed(case) + 100)
    q, sk = _keys(case, g)
    npos, hash_len = 8, 3
    n1 = -(-q.shape[0] // npos)
    hf = q.repeat(npos)[:n1 * npos].reshape(n1, npos)
    lengths = torch.randint(hash_len + 1, npos + hash_len, (n1,),
                            generator=g, dtype=I32)
    got = tdo._probe_join(hf, lengths, sk, hash_len, 16)
    want = _probe_join_by_scan(hf, lengths, sk, hash_len, 16)
    for a, b, what in zip(got, want, ("rk", "rleft", "rcnt", "h_total",
                                      "parts")):
        _equal(a, b, "%s %s" % (case, what))


# ------------------------------------------------- no scan on the main path

def _raise(*a, **k):
    raise AssertionError("a serial cummin/cummax scan ran")


def _block_scans(monkeypatch):
    for name in ("cummax", "cummin"):
        monkeypatch.setattr(torch, name, _raise)
        monkeypatch.setattr(torch.Tensor, name, _raise)
    with pytest.raises(AssertionError):
        torch.arange(3).cummax(0)


def _same(got, want, what):
    assert (got is None) == (want is None), what
    if want is None:
        return
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, "%s[%d]" % (what, i)
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, "%s[%d]" % (what, i)
        np.testing.assert_array_equal(g, w, err_msg="%s[%d]" % (what, i))


@pytest.mark.parametrize("name", ["se_small", "se_mixlen"])
def test_pipelines_run_without_scans(name, monkeypatch):
    """The device engine's stream and stream_canon (containment on), the
    hybrid's device shard (stream_canon without containment; the mixed
    set's raw stream besides) and the sharded engine at (4, 2), with every
    torch cummin/cummax raising, equal the JAX package's."""
    ds = Dataset([], [os.path.join(GOLDEN, name + ".fasta")], 40,
                 log=_quiet)
    n = ds.number_of_unique_reads
    a = 1 + int(n * 0.9)                      # the hybrid's default split
    mixed = ds.longest_read_length != ds.shortest_read_length
    jp = jdo.DeviceOverlapPipeline(ds, 40)
    jh = jdo.DeviceOverlapPipeline(ds, 40, row_lo=a)
    js = JSP(ds, 40, mesh=jmesh(dp=4, ix=2))
    want = {"stream": jp.stream(True), "canon": jp.stream_canon(True),
            "hybrid": jh.stream_canon(False), "sharded": js.stream(True)}
    if mixed:
        want["hybrid_raw"] = jh.stream_canon_raw_mixed()
        assert want["canon"] is not None and (want["canon"][2] != 0).any()

    _block_scans(monkeypatch)
    tp = tdo.DeviceOverlapPipeline(ds, 40, device=CPU)
    th = tdo.DeviceOverlapPipeline(ds, 40, row_lo=a, device=CPU)
    ts = TSP(ds, 40, mesh=tmesh(dp=4, ix=2, devices=[CPU] * 8))
    got = {"stream": tp.stream(True), "canon": tp.stream_canon(True),
           "hybrid": th.stream_canon(False), "sharded": ts.stream(True)}
    if mixed:
        got["hybrid_raw"] = th.stream_canon_raw_mixed()
    for what in want:
        _same(got[what], want[what], "%s %s" % (name, what))
    assert len(got["stream"][1]) > 0 and len(got["sharded"][1]) > 0
