"""The port's sharded engine (metagenomics_tpu_torch/parallel/) on in-process
meshes of CPU shards against the JAX package's on conftest's 8 virtual
devices: each stage's outputs in the global layout, the survivor streams,
the canonical stream, multi-chunk runs, the start-clamp regression, the
collective ledger, the true-layout helpers and the collectives
themselves.
Every value is an integer: exact equality throughout (uint32 values
compare as their int64 zero-extension, uint16 as int32)."""

import os

import numpy as np
import pytest
import torch

# one torch thread: the suite runs several workers side by side
torch.set_num_threads(1)

from metagenomics_tpu.dataset import Dataset
from metagenomics_tpu.ops import device_overlap as jdo
from metagenomics_tpu.parallel.collectives import LEDGER as JLEDGER
from metagenomics_tpu.parallel.mesh import make_mesh as jmesh
from metagenomics_tpu.parallel.sharded import ShardedOverlapPipeline as JSP
from metagenomics_tpu_torch.ops import device_overlap as tdo
from metagenomics_tpu_torch.parallel import collectives as tcoll
from metagenomics_tpu_torch.parallel.mesh import make_mesh as tmesh
from metagenomics_tpu_torch.parallel.sharded import \
    ShardedOverlapPipeline as TSP

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "golden", "data")
CPU = torch.device("cpu")
SPLITS = [(8, 1), (4, 2), (2, 4)]
NAMES = ["se_small", "se_mixlen"]


def _quiet(*a, **k):
    pass


def _ds(name):
    return Dataset([], [os.path.join(GOLDEN, name + ".fasta")], 40,
                   log=_quiet)


def _cpu_mesh(dp, ix):
    return tmesh(dp=dp, ix=ix, devices=[CPU] * (dp * ix))


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == np.uint32:
        return a.astype(np.int64)
    if a.dtype == np.uint16:
        return a.astype(np.int32)
    return a


def _equal(got, want, what):
    """Equal values in the same global order (the reference's [None]
    stage outputs add a leading axis the port's shards do not carry)."""
    g, w = _np(got).reshape(-1), _np(want).reshape(-1)
    assert g.shape == w.shape, "%s: size %s != %s" % (what, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=what)


_PIPES = {}


def _pipes(name, dp, ix):
    """(JAX pipeline, port pipeline) on one data set and split, built once
    per worker."""
    key = (name, dp, ix)
    if key not in _PIPES:
        ds = _ds(name)
        _PIPES[key] = (JSP(ds, 40, mesh=jmesh(dp=dp, ix=ix)),
                       TSP(ds, 40, mesh=_cpu_mesh(dp, ix)))
    return _PIPES[key]


def _single_chunk(p):
    """The single-chunk plan of stream(): (r0s, r1s, cap)."""
    assert int(p.dev_tot.max()) <= p.MAX_CAP
    cap = int(jdo._tier(max(int(p.dev_tot.max()), 1), lo=1 << 12))
    return (np.zeros(p.dp, np.int32), np.full(p.dp, p.nloc, np.int32), cap)


@pytest.mark.parametrize("dp,ix", SPLITS)
@pytest.mark.parametrize("name", NAMES)
def test_setup_stage(name, dp, ix):
    jp, tp = _pipes(name, dp, ix)
    assert (tp.cap_q, tp.cap_blk) == (jp.cap_q, jp.cap_blk)
    for attr in ("pslice_f", "pslice_r", "hf_sl", "keys_l", "id_l"):
        _equal(tp.global_(getattr(tp, attr)), getattr(jp, attr), attr)
    want = jp._setup()
    got = tp._setup()
    for g, w, what in zip(got[5:], want[5:], ("qcnt", "icnt")):
        _equal(tp.global_(g), w, what)


@pytest.mark.parametrize("dp,ix", SPLITS)
@pytest.mark.parametrize("name", NAMES)
def test_probe_stage(name, dp, ix):
    jp, tp = _pipes(name, dp, ix)
    for attr in ("pfwd", "prev", "lengths"):
        _equal(tp.global_(getattr(tp, attr), ix_replicated=True),
               getattr(jp, attr), attr)
    for attr in ("sid2", "rk", "rleft", "rcnt", "row_hits_cum"):
        _equal(tp.global_(getattr(tp, attr)), getattr(jp, attr), attr)
    _equal(tp.row_tot, jp.row_tot, "row_tot")
    _equal(tp.dev_tot, jp.dev_tot, "dev_tot")
    assert tp.grand == jp.grand > 0


@pytest.mark.parametrize("dp,ix", SPLITS)
@pytest.mark.parametrize("name", NAMES)
def test_owner_hist_and_emit_stages(name, dp, ix):
    jp, tp = _pipes(name, dp, ix)
    r0s, r1s, cap = _single_chunk(jp)
    hist = tp.global_(tp._owner_hist(r0s, r1s, cap, tp.rk, tp.rleft,
                                     tp.rcnt, tp.row_hits_cum, tp.sid2))
    jhist = jp._owner_hist(r0s, r1s, cap, jp.rk, jp.rleft, jp.rcnt,
                           jp.row_hits_cum, jp.sid2)
    _equal(hist, jhist, "owner_hist")
    m_blk = min(int(jdo._tier(max(int(hist.max()), 1), lo=1 << 8)), cap)
    mixed = name == "se_mixlen"
    dedup = "cont" if mixed else True
    got = tp._emit_chunk(r0s, r1s, cap, m_blk, mixed, tp.rk, tp.rleft,
                         tp.rcnt, tp.row_hits_cum, tp.sid2, tp.pfwd,
                         tp.prev, tp.lengths, dedup)
    want = jp._emit_chunk(r0s, r1s, cap, m_blk, mixed, jp.rk, jp.rleft,
                          jp.rcnt, jp.row_hits_cum, jp.sid2, jp.pfwd,
                          jp.prev, jp.lengths, dedup)
    for g, w, what in zip(got, want, ("qs", "r2s", "ms", "n_keep", "kc")):
        _equal(tp.global_(g, ix_replicated=True), w, what)
    assert int(tp.global_(got[3], ix_replicated=True).sum()) > 0


@pytest.mark.parametrize("check_cont", [True, False])
@pytest.mark.parametrize("dp,ix", SPLITS)
@pytest.mark.parametrize("name", NAMES)
def test_stream_matches_jax_and_single_device(name, dp, ix, check_cont):
    jp, tp = _pipes(name, dp, ix)
    got = tp.stream(check_cont=check_cont)
    want = jp.stream(check_cont=check_cont)
    single = tdo.DeviceOverlapPipeline(jp.ds, 40, device=CPU).stream(
        check_cont=check_cont)
    for g, w, s, what in zip(got, want, single, ("counts", "r2", "meta")):
        assert g.dtype == w.dtype == s.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)
        np.testing.assert_array_equal(g, s, err_msg=what)
    assert len(got[1]) > 0


def test_stream_ledger_matches_jax():
    """stream() at (4, 2) on se_small charges the collective ledger what
    the JAX package's stream() charges, with one emit phase, and its
    stream equals the JAX package's.  Fresh pipelines: the JAX ledger
    records a collective when its program is traced, which a cached
    pipeline has done."""
    ds = _ds("se_small")
    jp = JSP(ds, 40, mesh=jmesh(dp=4, ix=2))
    tp = TSP(ds, 40, mesh=_cpu_mesh(4, 2))

    def charged(ledger, pipe):
        ledger.reset()
        out = pipe.stream()
        return out, (dict(ledger.totals), dict(ledger.calls),
                     ledger.report()["phases"])
    stream, got = charged(tcoll.LEDGER, tp)
    jstream, want = charged(JLEDGER, jp)
    assert got == want and got[0] and got[1]["emit"] == 1
    for g, w, what in zip(stream, jstream, ("counts", "r2", "meta")):
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert len(stream[1]) > 0


def test_stream_canon_matches_jax():
    """tests/test_canon_stream.py:161 on the port: the canonical stream
    agrees record for record with the host-side canonical filter over the
    full stream, and equals the JAX sharded pipeline's (se_hard, (4, 2))."""
    ds = _ds("se_hard")
    assert ds.longest_read_length == ds.shortest_read_length
    tp = TSP(ds, 40, mesh=_cpu_mesh(4, 2))
    counts, r2, meta = tp.stream(check_cont=False)
    got = tp.stream_canon(check_cont=False)
    ccounts, cwords, csup, _ = got
    assert csup is None
    ob = tp.off_bits
    cr2 = (cwords >> np.uint32(4 + ob)).astype(np.int32)
    ceo = ((cwords >> np.uint32(ob)) & np.uint32(3)).astype(np.uint16)
    coff = (cwords & np.uint32((1 << ob) - 1)).astype(np.uint16)
    r1 = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    keep = (((meta >> 2) & 1).astype(bool)) & (r1 <= r2)
    want_counts = np.zeros(len(counts), np.int64)
    np.add.at(want_counts, r1[keep], 1)
    assert (ccounts == want_counts).all()
    assert (cr2 == r2[keep]).all()
    assert (ceo == (meta[keep] & 3)).all()
    assert (coff == (meta[keep] >> 4)).all()
    jgot = JSP(ds, 40, mesh=jmesh(dp=4, ix=2)).stream_canon(check_cont=False)
    for g, w in zip(got[:2], jgot[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_stream_canon_mixed_matches_jax():
    """The mixed-length canonical stream (containment resolved on the
    host) equals the JAX sharded pipeline's, supers and first hits
    included."""
    ds = _ds("se_mixlen")
    got = TSP(ds, 40, mesh=_cpu_mesh(2, 4)).stream_canon(check_cont=True)
    want = JSP(ds, 40, mesh=jmesh(dp=2, ix=4)).stream_canon(check_cont=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[2] != 0).any(), "no contained reads exercised"


def test_multichunk_matches_single_chunk(monkeypatch):
    """Forcing many row chunks (tiny per-shard buffer) must not change the
    stream: chunk windows, bounded all_gathers and the ring verify are
    exercised across chunk boundaries."""
    ds = _ds("se_hard")
    mesh = _cpu_mesh(4, 2)
    want = TSP(ds, 40, mesh=mesh).stream(check_cont=True)
    monkeypatch.setattr(TSP, "MAX_CAP", 1 << 13)
    tcoll.LEDGER.reset()
    got = TSP(ds, 40, mesh=mesh).stream(check_cont=True)
    assert tcoll.LEDGER.calls["emit"] > 1, "a single chunk ran"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _fuzz_reads(tmp_path, seed):
    """tests/test_sharded.py's random mixed-length set."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, np.uint8)
    for k, v in zip(b"ACGT", b"TGCA"):
        comp[k] = v
    glen = int(rng.integers(20_000, 60_000))
    g = bases[rng.integers(0, 4, glen)]
    n = int(rng.integers(3_000, 9_000))
    lens = rng.integers(60, 140, n)
    starts = rng.integers(0, glen - 140, n)
    path = tmp_path / "f.fasta"
    with open(path, "wb") as f:
        for t in range(n):
            r = g[starts[t]:starts[t] + int(lens[t])]
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            f.write(b">r%d\n" % t)
            f.write(r.tobytes())
            f.write(b"\n")
    return str(path)


@pytest.mark.parametrize("seed,mo", [(100, 40), (103, 30)])
def test_sharded_fuzz_random_mixed(seed, mo, tmp_path):
    """Random mixed-length sets at stressed splits equal the single-device
    stream exactly (tests/test_sharded.py's fuzz on the port)."""
    ds = Dataset([], [_fuzz_reads(tmp_path, seed)], mo, log=_quiet)
    base = tdo.DeviceOverlapPipeline(ds, mo, device=CPU).stream(
        check_cont=True)
    for dp, ix in ((4, 2), (2, 4)):
        out = TSP(ds, mo, mesh=_cpu_mesh(dp, ix)).stream(check_cont=True)
        for a, b in zip(base, out):
            np.testing.assert_array_equal(a, b)


def test_ring_start_clamp_pe_real(monkeypatch):
    """The regression for the dynamic_slice start clamp found on pe_real:
    at (4, 2) some ring block's window would run past the buffer's end, so
    the reference's slice start is clamped (asserted to occur here) and
    the block is masked by global position; the stream still equals the
    JAX sharded pipeline's and the single-device one's."""
    from metagenomics_tpu_torch.parallel import sharded
    ds = Dataset([os.path.join(GOLDEN, "pe_real.fastq")], [], 40,
                 log=_quiet)
    clamped = []
    clamp = sharded._clamped_start

    def spy(start, cap, m_blk):
        clamped.append(int(start) > cap - m_blk)
        return clamp(start, cap, m_blk)
    monkeypatch.setattr(sharded, "_clamped_start", spy)
    got = TSP(ds, 40, mesh=_cpu_mesh(4, 2)).stream(check_cont=False)
    assert any(clamped), "no ring block start was clamped"
    want = JSP(ds, 40, mesh=jmesh(dp=4, ix=2)).stream(check_cont=False)
    single = tdo.DeviceOverlapPipeline(ds, 40, device=CPU).stream(
        check_cont=False)
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


def test_ledger_matches_jax():
    """Payload bytes per (phase, op, axis, axis_size) and the phase
    invocation counts equal the JAX ledger's (se_small, (4, 2))."""
    ds = _ds("se_small")
    JLEDGER.reset()
    JSP(ds, 40, mesh=jmesh(dp=4, ix=2)).stream(check_cont=False)
    tcoll.LEDGER.reset()
    TSP(ds, 40, mesh=_cpu_mesh(4, 2)).stream(check_cont=False)
    assert dict(tcoll.LEDGER.totals) == dict(JLEDGER.totals)
    assert dict(tcoll.LEDGER.calls) == dict(JLEDGER.calls)
    rep, jrep = tcoll.LEDGER.report(), JLEDGER.report()
    assert rep["phases"] == jrep["phases"]
    assert rep["total_wire_bytes"] == jrep["total_wire_bytes"] > 0
    ops = {c["op"] for p in rep["phases"].values() for c in p["collectives"]}
    assert {"all_gather", "all_to_all", "ppermute", "psum"} <= ops
    model = rep["model"]
    assert model["nvlink_bytes_per_s"] == tcoll.NVLINK_BYTES_PER_S
    assert model["projected_nvlink_seconds"] == \
        rep["total_wire_bytes"] / tcoll.NVLINK_BYTES_PER_S


def test_rc_codes_matches_jax():
    """The true-layout reverse complement, lengths 0..lmax, codes 0..4
    (an N code complements to 255 in uint8 in both)."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 5, (40, 37)).astype(np.uint8)
    lengths = rng.integers(0, 38, 40).astype(np.int32)
    lengths[:2] = (0, 37)
    want = np.asarray(jdo._rc_codes(codes, lengths))
    got = tdo._rc_codes(torch.from_numpy(codes), torch.from_numpy(lengths))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("check_cont", [True, False])
def test_verify_windows_true_layout_matches_jax(check_cont):
    """_verify_windows with rev_shift=None on true-layout reverse rows,
    every (r1, j, r2, orient) of random reads with planted overlaps."""
    rng = np.random.default_rng(4)
    n, lmax, l = 24, 70, 9
    lengths = rng.integers(l + 2, lmax + 1, n).astype(np.int32)
    codes = rng.integers(0, 4, (n, lmax)).astype(np.uint8)
    codes[1, :20] = codes[0, lengths[0] - 20:lengths[0]]
    codes[3, :lengths[2]] = codes[2, :lengths[2]]
    rev = np.asarray(jdo._rc_codes(codes, lengths))
    w = (lmax + 15) // 16
    qw_max = (lmax - l) >> 4
    pad = ((0, 0), (0, qw_max + 1))
    pf = np.pad(jdo.pack_codes_host(codes), pad)
    pr = np.pad(jdo.pack_codes_host(rev), pad)
    r1, j, r2, orient = (a.ravel() for a in np.meshgrid(
        np.arange(n), np.arange(0, lmax - l + 1, 5), np.arange(n),
        np.arange(4), indexing="ij"))
    rows2 = np.where((orient > 1)[:, None], pr[r2], pf[r2])
    args = (pf[r1], rows2, lengths[r1], lengths[r2], j.astype(np.int32),
            orient.astype(np.int32))
    want = jdo._verify_windows(*args, l, w, qw_max, check_cont, None)
    t = tdo.from_jax_arrays(dict(enumerate(args)), CPU)
    got = tdo._verify_windows(*(t[k].to(torch.int64) for k in range(6)), l,
                              w, qw_max, check_cont, rev_shift=None)
    for g, x, what in zip(got, want, ("edge_ok", "cont_ok", "eo", "eoff")):
        _equal(g, x, what)
    assert got[0].any() and not got[0].all()
    if check_cont:
        assert got[1].any()


def test_in_process_collectives():
    """The in-process backend's semantics on a (2, 4) mesh: all_gather
    concatenates in axis order, all_to_all swaps block s of shard t with
    block t of shard s, the ring hands shard d the tensor of shard d+1,
    psum sums; uint32 values held in int64 cross as 32 bits and come back
    equal, and each call charges one shard's 32-bit payload."""
    mesh = _cpu_mesh(2, 4)
    comm = mesh.comm
    big = 0xFFFFFFF0
    xs = {(d, i): torch.tensor([big + 10 * d + i, d, i]) for d, i in
          mesh.local}
    tcoll.LEDGER.reset()
    with tcoll.LEDGER.phase("t"):
        ag = comm.all_gather(xs, "ix")
        ring = comm.ppermute(xs)
        blocks = {k: torch.arange(4, dtype=torch.int32)[:, None] * 100
                  + 10 * k[0] + k[1] for k in mesh.local}
        a2a = comm.all_to_all(blocks, "ix")
        ps = comm.psum({k: torch.tensor(k[1], dtype=torch.int32)
                        for k in mesh.local}, "dp")
    for d, i in mesh.local:
        assert ag[d, i].tolist() == torch.cat(
            [xs[d, k] for k in range(4)]).tolist()
        assert ring[d, i].tolist() == xs[(d + 1) % 2, i].tolist()
        assert a2a[d, i][:, 0].tolist() == [100 * i + 10 * d + s
                                            for s in range(4)]
        assert int(ps[d, i]) == 2 * i
    assert dict(tcoll.LEDGER.totals) == {
        ("t", "all_gather", "ix", 4): 12, ("t", "ppermute", "dp", 2): 12,
        ("t", "all_to_all", "ix", 4): 16, ("t", "psum", "dp", 2): 4}


def test_mesh_shapes_and_default_split():
    """make_mesh's checks and the pipeline's default split: one shard on
    the CPU; ix = 2 from four shards up (sharded.py:128-131)."""
    with pytest.raises(ValueError, match="device count"):
        tmesh(dp=3, ix=2, devices=[CPU] * 8)
    m = tmesh(ix=2, devices=[CPU] * 8)
    assert m.shape == {"dp": 4, "ix": 2} and len(m.local) == 8
    ds = _ds("se_small")
    with pytest.raises(ValueError, match="power of two"):
        TSP(ds, 40, mesh=_cpu_mesh(1, 3))
    tp = TSP(ds, 40, device=CPU)
    assert (tp.dp, tp.ix) == (1, 1)
