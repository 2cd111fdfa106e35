"""The port's eval and prep tools (metagenomics_tpu_torch.tools: fac,
format_fasta, shuffle) run through `python -m` and give the JAX
package's tools' output byte for byte, on the goldens and on the
synthetic inputs of tests/test_tools.py.  No Perl is needed."""

import os
import random
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("metagenomics_tpu", "metagenomics_tpu_torch")


def _run(pkg, tool, args):
    proc = subprocess.run(
        [sys.executable, "-m", "%s.tools.%s" % (pkg, tool), *args],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    return proc.returncode, proc.stdout, proc.stderr


def _same(tool, args):
    ref, port = (_run(pkg, tool, args) for pkg in PACKAGES)
    assert port == ref, (tool, args)
    return port


@pytest.fixture(scope="module")
def contigs(tmp_path_factory):
    """tests/test_tools.py's synthetic contig sets (>= 1e7 totals, short
    contigs under various thresholds), and an empty file."""
    d = tmp_path_factory.mktemp("contigs")
    rng = random.Random(9)
    paths = []
    for fi in range(3):
        p = d / ("c%d.fasta" % fi)
        with open(p, "w") as f:
            for i in range(rng.randrange(3, 30)):
                ln = rng.choice([50, 150, 700, 5000, 800000])
                f.write(">c%d\n" % i)
                s = "".join(rng.choice("ACGTN") for _ in range(ln))
                for k in range(0, ln, 80):
                    f.write(s[k:k + 80] + "\n")
        paths.append(str(p))
    big = d / "big.fasta"
    with open(big, "w") as f:
        for i in range(14):
            f.write(">b%d\n" % i + "A" * 900000 + "\n")
    paths.append(str(big))
    empty = d / "empty.fasta"
    empty.write_text("")
    return paths, str(empty)


def test_fac_on_goldens():
    out = os.path.join(REPO, "golden", "out")
    files = sorted(os.path.join(out, d, "g_contigs%d.fasta" % k)
                   for d in os.listdir(out) for k in (1, 4)
                   if os.path.exists(os.path.join(out, d,
                                                  "g_contigs%d.fasta" % k)))
    assert files
    rc, stdout, _ = _same("fac", files)
    assert rc == 0 and stdout.count("\n") == len(files) + 1


@pytest.mark.parametrize("opts", [
    "first", "all", "-t 100", "-t 1000", "-g 2000000", "-j", "empty"])
def test_fac_options(contigs, opts):
    paths, empty = contigs
    args = {"first": [paths[0]], "all": paths,
            "empty": [empty, paths[0]]}.get(opts, opts.split() + paths)
    rc, stdout, _ = _same("fac", args)
    assert rc == 0 and stdout


FASTA_CASES = [
    b">a\nacgt\nACGT\n>b desc\nttt\n",
    b"junk\nmore junk\n>a\nacg\ntac\n",
    b">a\r\nac\r\ngt\r\n>b\nTT\n",
    b">only_header\n",
    b">a\nACGT\n>b\nGG\n>c\nAAAA\nCCC\n",
    b">a\nACGT",
]


@pytest.mark.parametrize("k", range(len(FASTA_CASES)))
def test_format_fasta(tmp_path, k):
    p = tmp_path / ("f%d.fa" % k)
    p.write_bytes(FASTA_CASES[k])
    rc, stdout, _ = _same("format_fasta", [str(p)])
    assert rc == 0 and stdout.startswith(">")


@pytest.mark.parametrize("fmt,to_stdout", [
    ("fasta", False), ("fastq", False), ("fasta", True)])
def test_shuffle(tmp_path, fmt, to_stdout):
    a, b = tmp_path / ("r1." + fmt), tmp_path / ("r2." + fmt)
    if fmt == "fasta":
        # multi-line records and uneven record counts
        a.write_text(">p1/1\nACGT\nTTTT\n>p2/1\nGGG\n>p3/1\nCC\n")
        b.write_text(">p1/2\nTTAA\n>p2/2\nAAA\nC\n")
    else:
        a.write_text("@p1/1\nACGT\n+\nIIII\n@p2/1\nGG\n+\nII\n")
        b.write_text("@p1/2\nTTAA\n+\nIIII\n")
    if to_stdout:
        rc, stdout, _ = _same("shuffle", [str(a), str(b)])
        assert rc == 0 and stdout.startswith(">p1/1")
        return
    outs = []
    for pkg in PACKAGES:
        out = tmp_path / (pkg + ".out")
        assert _run(pkg, "shuffle", [str(a), str(b), str(out)])[0] == 0
        outs.append(out.read_bytes())
    assert outs[1] == outs[0] and outs[0]
