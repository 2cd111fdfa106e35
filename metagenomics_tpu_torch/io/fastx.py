"""FASTA/FASTQ record iteration with the reference's exact stream semantics.

The reference (MetaGenomics/Dataset.cpp:110-193, 208-310) reads records with
std::getline in a `while(!eof())` loop:

* FASTA: one header getline + one '>'-delimited getline per record (newlines
  stripped from the sequence), so multi-line sequences are concatenated and
  the loop ends exactly at the last record.
* FASTQ: four getlines per record; because the trailing newline of the last
  record does not set eofbit, the loop runs one extra iteration yielding an
  empty sequence (which then fails QC and is counted as a bad read).  We
  reproduce that spurious record so read-accounting matches.

Paired-end variants consume two records per loop iteration (mates adjacent).

Files are STREAMED through a fixed-size buffer (like the reference's
getline loop), so resident memory is bounded by the chunk size plus one
record — not the file size.
"""


class _Stream:
    """std::istream getline + eofbit semantics over a chunk-buffered file."""

    CHUNK = 1 << 22

    def __init__(self, f):
        self.f = f
        self.buf = ""
        self.pos = 0
        self.eof = False          # istream eofbit
        self._exhausted = False   # underlying file fully read

    def _fill(self) -> bool:
        if self._exhausted:
            return False
        chunk = self.f.read(self.CHUNK)
        if not chunk:
            self._exhausted = True
            return False
        self.buf = self.buf[self.pos:] + chunk
        self.pos = 0
        return True

    def getline(self, delim: str = "\n") -> str:
        while True:
            idx = self.buf.find(delim, self.pos)
            if idx != -1:
                s = self.buf[self.pos: idx]
                self.pos = idx + 1
                return s
            if not self._fill():
                break
        if self.pos >= len(self.buf):
            self.eof = True
            return ""
        s = self.buf[self.pos:]
        self.pos = len(self.buf)
        self.eof = True
        return s


def detect_format(text: str) -> str:
    from ..errors import MyExit
    if text[:1] == ">":
        return "fasta"
    if text[:1] == "@":
        return "fastq"
    # reference: MYEXIT("Unknown input file format.") (Dataset.cpp:135)
    raise MyExit("Unknown input file format.")


def _open_stream(path):
    try:
        f = open(path)
    except OSError:
        from ..errors import MyExit
        # reference: MYEXIT("Unable to open file: ...") (Dataset.cpp:117)
        raise MyExit("Unable to open file: " + path) from None
    st = _Stream(f)
    st._fill()
    return f, st, detect_format(st.buf[:1])


def fastx_records(path: str):
    """Yield uppercased sequence strings, one per record, reference-style."""
    f, st, fmt = _open_stream(path)
    with f:
        if fmt == "fasta":
            while not st.eof:
                st.getline()
                seq = st.getline(">").replace("\n", "")
                yield seq.upper()
        else:
            while not st.eof:
                lines = [st.getline() for _ in range(4)]
                yield lines[1].upper()


def fastx_pairs(path: str):
    """Yield uppercased (seq1, seq2) mate pairs, two records per iteration."""
    f, st, fmt = _open_stream(path)
    with f:
        if fmt == "fasta":
            while not st.eof:
                st.getline()
                s1 = st.getline(">").replace("\n", "")
                st.getline()
                s2 = st.getline(">").replace("\n", "")
                yield s1.upper(), s2.upper()
        else:
            while not st.eof:
                lines = [st.getline() for _ in range(8)]
                yield lines[1].upper(), lines[5].upper()
